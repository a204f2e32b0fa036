// Kernel B: multi-resolution hash-grid encoding, forward.
//
// Replaces the TPU lookup of arcnerf_tpu/models/base_modules/encoding.py
// (_hash_lookup_fused and its paired/row-form siblings) and computes the
// numbers of HashGridEmbedder's CPU element path (_gather_cols_f32): per
// (point, level) the corner entries and trilinear weights of hash_grid.cuh,
// and each table entry read rounded to bf16, summed in f32.
//
// What bounds it on the H100: random 8-byte reads from a 64 MB table
// (16 levels x 2^19 entries x F=2 f32) - 8 corners x 16 levels per point,
// so HBM/L2 latency and sector efficiency, not arithmetic. Design: one
// thread per (point, level), with the level the fastest-varying index, so a
// warp covers two points: the xyz reads broadcast, the (B, L*F) output
// rows are written contiguously, and all 8 corner reads of a thread are
// independent loads in flight together. The coarse dense levels stay hot in
// L2. Coalescing the hashed corners (the TPU's quad/pair row trick) is
// later work.

#include "hash_grid.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(256) hash_encode_fwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ table, int n_levels,
        uint32_t table_size, const int* __restrict__ res, float mn0, float mn1, float mn2, float len0,
        float len1, float len2, int variant, int read_bf16, float* __restrict__ out) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n_pts * n_levels) return;
    const int64_t b = idx / n_levels;
    const int l = static_cast<int>(idx - b * n_levels);

    uint32_t entry[8];
    float w[8];
    hash_grid::corners(xyz[3 * b + 0], xyz[3 * b + 1], xyz[3 * b + 2], res[l], mn0, mn1, mn2, len0, len1, len2,
                       table_size, variant, entry, w);
    const float* tab = table + static_cast<int64_t>(l) * table_size * F;

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float* e = tab + static_cast<int64_t>(entry[c]) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) {
            const float v = read_bf16 ? round_bf16(e[f]) : e[f];
            acc[f] = __fadd_rn(acc[f], __fmul_rn(v, w[c]));
        }
    }
    float* o = out + b * (static_cast<int64_t>(n_levels) * F) + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
}

template <int F>
int launch(const float* xyz, int64_t n_pts, const float* table, int n_levels, uint32_t table_size,
           const int* res, const float* mn, const float* len, int variant, int read_bf16, float* out,
           cudaStream_t stream) {
    const int threads = 256;
    const int64_t total = n_pts * n_levels;
    const int64_t blocks = (total + threads - 1) / threads;
    hash_encode_fwd_kernel<F><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
        xyz, n_pts, table, n_levels, table_size, res, mn[0], mn[1], mn[2], len[0], len[1], len[2], variant,
        read_bf16, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (n_pts, 3) f32; table (n_levels, 2^log2_table, n_feat) f32; res
// (n_levels,) int32 on the device; aabb_min/aabb_len (3,) f32 on the host;
// variant 0 ngp / 1 pair / 2 quad; out (n_pts, n_levels * n_feat) f32.
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
