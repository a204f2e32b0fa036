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
// What bounds it on the H100: 8 f32 atomic adds per (point, level) and
// feature into a 64 MB table, so L2 atomic throughput - and, on the coarse
// dense levels, collisions: level 0 has 16^3 = 4096 entries for ~2M corner
// adds per step at 2^18 points, so its atomics serialise on a few cache
// lines. Design: one thread per (point, level), level fastest as in kernel
// B, recomputing the corners with the same hash_grid::corners so that the
// scatter hits exactly the entries the forward read; plain f32 atomicAdd.
// A redesign of the dense levels (privatised shared-memory partial tables,
// or a sort-and-segment-sum) is the first thing to attack when this kernel
// shows in a profile.

#include "hash_grid.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(256) hash_encode_bwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ g, int n_levels,
        uint32_t table_size, const int* __restrict__ res, float mn0, float mn1, float mn2, float len0,
        float len1, float len2, int variant, float* __restrict__ grad) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n_pts * n_levels) return;
    const int64_t b = idx / n_levels;
    const int l = static_cast<int>(idx - b * n_levels);

    float gf[F];
    const float* gr = g + b * (static_cast<int64_t>(n_levels) * F) + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = gr[f];

    uint32_t entry[8];
    float w[8];
    hash_grid::corners(xyz[3 * b + 0], xyz[3 * b + 1], xyz[3 * b + 2], res[l], mn0, mn1, mn2, len0, len1, len2,
                       table_size, variant, entry, w);
    float* tab = grad + static_cast<int64_t>(l) * table_size * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        float* e = tab + static_cast<int64_t>(entry[c]) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(e + f, __fmul_rn(w[c], gf[f]));
    }
}

template <int F>
int launch(const float* xyz, int64_t n_pts, const float* g, int n_levels, uint32_t table_size, const int* res,
           const float* mn, const float* len, int variant, float* grad, cudaStream_t stream) {
    const int threads = 256;
    const int64_t total = n_pts * n_levels;
    const int64_t blocks = (total + threads - 1) / threads;
    hash_encode_bwd_kernel<F><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
        xyz, n_pts, g, n_levels, table_size, res, mn[0], mn[1], mn[2], len[0], len[1], len[2], variant, grad);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (n_pts, 3) f32; g (n_pts, n_levels * n_feat) f32, the gradient of the
// encoding; res (n_levels,) int32 on the device; aabb_min/aabb_len (3,) f32
// on the host; variant 0 ngp / 1 pair / 2 quad; grad (n_levels,
// 2^log2_table, n_feat) f32, zeroed by the caller, accumulated into.
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
