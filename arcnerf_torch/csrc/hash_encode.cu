// Kernel B: multi-resolution hash-grid encoding, forward.
//
// Replaces the TPU lookup of arcnerf_tpu/models/base_modules/encoding.py
// (_hash_lookup_fused and its paired/row-form siblings) and computes the
// numbers of HashGridEmbedder's CPU element path (_gather_cols_f32): per
// (point, level) the corner entries and trilinear weights of hash_grid.cuh,
// and each table entry read rounded to bf16, summed in f32 in corner order
// (0-7, _CORNER_OFFSETS) with unfused multiplies and adds, so the result is
// bit-identical to hash_encode_reference.
//
// What bounds it on the H100: random 4F-byte reads from a 64 MB table
// (16 levels x 2^19 entries x F=2 f32, more than the 50 MB L2), 8 corners
// x 16 levels a point: HBM/L2 latency and sector efficiency, not
// arithmetic. Design, level-major warps:
// - a block takes 32 consecutive points and one warp a level (16 warps
//   for the recipe's 16 levels; more levels go in chunks of 16), each lane
//   one point. The training stream is ray-ordered, so at the coarse levels
//   the lanes of a warp fall in the same or neighbouring cells and one L1
//   line serves them; every lane of a warp reads the same level's table;
// - the block reads its points' xyz once and normalises them
//   into shared memory (the divides once a point, not once a level);
// - no 64-bit divide: the point and the level come from the lane and the
//   warp;
// - one vector load a corner (float2 for F = 2, float4 for F = 4, two for
//   F = 8), all 8 in flight before the sums;
// - the block puts its (32 x L F) output tile together in shared memory
//   (rows padded by one float, so a warp's stores fall in 32 banks) and
//   writes it as whole rows, consecutive threads on consecutive floats.
// hash_grid::corners is also kernel E's, so the scatter adds into exactly
// the entries this kernel reads.

#include "hash_grid.cuh"

namespace {

constexpr int kPoints = 32;  // points a block: one a lane
constexpr int kWarps = 16;   // levels a block takes at once: one a warp

// The F values of table entry e (of a level's table tab) in one vector load.
template <int F>
__device__ __forceinline__ void load_entry(const float* __restrict__ tab, uint32_t e, float (&v)[F]) {
    if constexpr (F == 1) {
        v[0] = __ldg(tab + e);
    } else if constexpr (F == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(tab) + e);
        v[0] = t.x;
        v[1] = t.y;
    } else {
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(tab) + static_cast<int64_t>(e) * (F / 4) + q);
            v[4 * q + 0] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
        }
    }
}

template <int F>
__global__ void __launch_bounds__(kPoints * kWarps) hash_encode_fwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ table, int n_levels,
        uint32_t table_size, const int* __restrict__ res, float mn0, float mn1, float mn2, float len0,
        float len1, float len2, int variant, int read_bf16, float* __restrict__ out) {
    constexpr int kStride = kWarps * F + 1;  // a tile row, padded
    __shared__ float3 norm[kPoints];
    __shared__ float tile[kPoints * kStride];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int threads = blockDim.x;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPoints;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPoints), n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], mn0, mn1, mn2, len0, len1, len2);
    }
    __syncthreads();

    const int row = n_levels * F;
    for (int l0 = 0; l0 < n_levels; l0 += kWarps) {
        const int chunk = min(kWarps, n_levels - l0);  // levels in this chunk
        const int l = l0 + warp;
        if (warp < chunk && lane < n_here) {
            uint32_t entry[8];
            float w[8];
            hash_grid::corners(norm[lane], res[l], table_size, variant, entry, w);
            const float* tab = table + static_cast<int64_t>(l) * table_size * F;
            float v[8][F];
#pragma unroll
            for (int c = 0; c < 8; ++c) load_entry<F>(tab, entry[c], v[c]);
            float acc[F];
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    const float e = read_bf16 ? round_bf16(v[c][f]) : v[c][f];
                    acc[f] = __fadd_rn(acc[f], __fmul_rn(e, w[c]));
                }
            }
#pragma unroll
            for (int f = 0; f < F; ++f) tile[lane * kStride + warp * F + f] = acc[f];
        }
        __syncthreads();
        const int cols = chunk * F;
        float* dst = out + p0 * row + l0 * F;
        for (int i = threadIdx.x; i < n_here * cols; i += threads) {
            const int r = i / cols, c = i - r * cols;
            dst[static_cast<int64_t>(r) * row + c] = tile[r * kStride + c];
        }
        __syncthreads();
    }
}

template <int F>
int launch(const float* xyz, int64_t n_pts, const float* table, int n_levels, uint32_t table_size,
           const int* res, const float* mn, const float* len, int variant, int read_bf16, float* out,
           cudaStream_t stream) {
    const int64_t blocks = (n_pts + kPoints - 1) / kPoints;
    if (blocks > 0x7fffffff) return ARCNERF_BAD_ARGUMENT;
    const int threads = kPoints * min(n_levels, kWarps);
    hash_encode_fwd_kernel<F><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
        xyz, n_pts, table, n_levels, table_size, res, mn[0], mn[1], mn[2], len[0], len[1], len[2], variant,
        read_bf16, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (n_pts, 3) f32; table (n_levels, 2^log2_table, n_feat) f32, aligned
// to min(4 n_feat, 16) bytes; res (n_levels,) int32 on the device;
// aabb_min/aabb_len (3,) f32 on the host; variant 0 ngp / 1 pair / 2 quad;
// out (n_pts, n_levels * n_feat) f32.
extern "C" int arcnerf_hash_encode_fwd(const void* xyz, long long n_pts, const void* table, int n_levels,
                                       int log2_table, int n_feat, const void* res, const float* aabb_min,
                                       const float* aabb_len, int variant, int read_bf16, void* out,
                                       void* stream) {
    if (n_pts <= 0 || n_levels <= 0 || log2_table < 1 || log2_table > 30 || variant < 0 || variant > 2)
        return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(xyz);
    const float* tp = static_cast<const float*>(table);
    const int* rp = static_cast<const int*>(res);
    float* op = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t t = 1u << log2_table;
    switch (n_feat) {
        case 1: return launch<1>(xp, n_pts, tp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 2: return launch<2>(xp, n_pts, tp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 4: return launch<4>(xp, n_pts, tp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 8: return launch<8>(xp, n_pts, tp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
