// Kernel E: multi-resolution hash-grid encoding, backward - the table
// scatter.
//
// Computes the table gradient of HashGridEmbedder's CPU element path
// (_gather_cols_f32_bwd in arcnerf_tpu/models/base_modules/encoding.py,
// the counterpart of the TPU's _hash_lookup_fused_bwd): for every point b,
// level l and corner c, grad[l, entry_c, f] += w_c * g[b, l * F + f]. The
// gradient passes straight through the forward's bf16 read and accumulates
// in f32 (the TPU's bf16 one-hot-matmul rounding is not copied). The xyz
// gradient is not computed: sample points carry no parameters.
//
// What bounds it on the H100: the atomic adds into the table, which L2
// performs one request at a time per address, so their number. Design:
// - level-major: blocks over (256 consecutive points, level), level
//   slowest, so a warp holds 32 consecutive points of one level and the
//   card works through the levels a few at a time, one level's table (4 MB
//   at T = 2^19, F = 2) hot in L2 rather than all sixteen;
// - warp aggregation: per update, the lanes whose destination is the same
//   (__match_any_sync) sum their terms by shuffles and the group's lowest
//   lane adds the sum. On the training stream consecutive samples of a ray
//   lie 2 sqrt(3) / 512 apart, inside one cell of the coarse levels, so
//   their adds collapse there; on the fine levels most groups have one lane;
// - vector atomics: for F <= 2 a destination is a slot of two entries
//   (2s, 2s + 1) and one 8F-byte atomic (float4 for F = 2, float2 for F = 1)
//   adds both. The z-neighbour corners (c, c + 4) of the dense levels and
//   of the quad and pair hashes sit at entries e and e + 1, so half the
//   time they share a slot and go as one atomic: 6 a point and level
//   instead of 8 on average (the ngp hash's hashed levels keep 8). For
//   F = 4 one float4 a corner, for F = 8 two;
// - updates whose values are all exactly 0 are not issued: the compacted
//   stream's padding rows (g = 0), and the second update of a corner pair
//   that went as one. The table starts at +0, and the zero half of a slot
//   that rides along adds +-0, which leaves an entry as it is.
// Shared-memory partial tables for the dense levels 0 and 1 were measured
// and left out: on the training stream the aggregation above leaves those
// levels few adds, and the few long blocks that would own a partial table
// outlast the rest of the grid (PERF.md, section 6).
// The corners come from the same hash_grid::corners as kernel B, so the
// scatter hits exactly the entries the forward read. Sums land in an order
// that changes from run to run.

#include "hash_grid.cuh"
#include "hash_scatter.cuh"

namespace {

constexpr int kThreads = 256;
using hash_scatter::add_half;
using hash_scatter::add_vector;
using hash_scatter::any_nonzero;
using hash_scatter::warp_group_sum;

template <int F>
__global__ void __launch_bounds__(kThreads) hash_encode_bwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ g, int n_levels,
        uint32_t table_size, const int* __restrict__ res, float mn0, float mn1, float mn2, float len0,
        float len1, float len2, int variant, float* __restrict__ grad) {
    const int l = blockIdx.y;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    // whole warps past the end leave; the last warp's lanes past the end
    // stay for the warp-wide sums, on the last point with g = 0
    if (i - (threadIdx.x & 31) >= n_pts) return;
    const bool live = i < n_pts;
    const int64_t b = live ? i : n_pts - 1;

    float gf[F];
    const float* gr = g + b * (static_cast<int64_t>(n_levels) * F) + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = live ? gr[f] : 0.f;

    uint32_t entry[8];
    float w[8];
    hash_grid::corners(xyz[3 * b + 0], xyz[3 * b + 1], xyz[3 * b + 2], res[l], mn0, mn1, mn2, len0, len1, len2,
                       table_size, variant, entry, w);
    float* tab = grad + static_cast<int64_t>(l) * table_size * F;
    if constexpr (F <= 2) {
        // corner p (z = 0) and its z-neighbour p + 4: one slot update for
        // both when they share a slot, else one each (the second then adds
        // zeros, which the group sum drops)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint32_t ea = entry[p], eb = entry[p + 4];
            const bool joint = (ea >> 1) == (eb >> 1);
            float ta[F], tb[F], va[2 * F] = {}, vb[2 * F] = {};
#pragma unroll
            for (int f = 0; f < F; ++f) {
                ta[f] = __fmul_rn(w[p], gf[f]);
                tb[f] = __fmul_rn(w[p + 4], gf[f]);
            }
            add_half<F>(ea, ta, va);
            if (joint) {
                add_half<F>(eb, tb, va);
            } else {
                add_half<F>(eb, tb, vb);
            }
            if (warp_group_sum<2 * F>(ea >> 1, va) && any_nonzero(va))
                add_vector(tab + static_cast<int64_t>(ea >> 1) * 2 * F, va);
            if (warp_group_sum<2 * F>(eb >> 1, vb) && any_nonzero(vb))
                add_vector(tab + static_cast<int64_t>(eb >> 1) * 2 * F, vb);
        }
    } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float v[F];
#pragma unroll
            for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w[c], gf[f]);
            if (warp_group_sum<F>(entry[c], v) && any_nonzero(v))
                add_vector(tab + static_cast<int64_t>(entry[c]) * F, v);
        }
    }
}

template <int F>
int launch(const float* xyz, int64_t n_pts, const float* g, int n_levels, uint32_t table_size, const int* res,
           const float* mn, const float* len, int variant, float* grad, cudaStream_t stream) {
    const int64_t chunks = (n_pts + kThreads - 1) / kThreads;
    if (chunks > 0x7fffffff || n_levels > 65535) return ARCNERF_BAD_ARGUMENT;
    const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(n_levels));
    hash_encode_bwd_kernel<F><<<grid, kThreads, 0, stream>>>(xyz, n_pts, g, n_levels, table_size, res, mn[0], mn[1],
                                                             mn[2], len[0], len[1], len[2], variant, grad);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (n_pts, 3) f32; g (n_pts, n_levels * n_feat) f32, the gradient of the
// encoding; res (n_levels,) int32 on the device; aabb_min/aabb_len (3,) f32
// on the host; variant 0 ngp / 1 pair / 2 quad; grad (n_levels,
// 2^log2_table, n_feat) f32, zeroed by the caller (torch.zeros: 16-byte
// aligned), accumulated into.
extern "C" int arcnerf_hash_encode_bwd(const void* xyz, long long n_pts, const void* g, int n_levels,
                                       int log2_table, int n_feat, const void* res, const float* aabb_min,
                                       const float* aabb_len, int variant, void* grad, void* stream) {
    if (n_pts <= 0 || n_levels <= 0 || log2_table < 1 || log2_table > 30 || variant < 0 || variant > 2)
        return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(xyz);
    const float* gp = static_cast<const float*>(g);
    const int* rp = static_cast<const int*>(res);
    float* op = static_cast<float*>(grad);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t t = 1u << log2_table;
    switch (n_feat) {
        case 1: return launch<1>(xp, n_pts, gp, n_levels, t, rp, aabb_min, aabb_len, variant, op, s);
        case 2: return launch<2>(xp, n_pts, gp, n_levels, t, rp, aabb_min, aabb_len, variant, op, s);
        case 4: return launch<4>(xp, n_pts, gp, n_levels, t, rp, aabb_min, aabb_len, variant, op, s);
        case 8: return launch<8>(xp, n_pts, gp, n_levels, t, rp, aabb_min, aabb_len, variant, op, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
