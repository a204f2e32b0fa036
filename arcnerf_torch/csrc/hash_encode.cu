// Kernel B: multi-resolution hash-grid encoding, forward.
//
// Replaces the TPU lookup of arcnerf_tpu/models/base_modules/encoding.py
// (_hash_lookup_fused and its paired/row-form siblings) and computes the
// numbers of HashGridEmbedder's CPU element path (_gather_cols_f32): per
// (point, level) the level resolution, the corner entries of the dense or
// hashed level (quad, pair or instant-ngp hash, uint32 wrapping multiplies,
// & (T-1)), the 8 trilinear weights in _CORNER_OFFSETS order, and each
// table entry read rounded to bf16, summed in f32.
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

#include "common.cuh"

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kQuadSY = 31u;
enum Variant { kNgp = 0, kPair = 1, kQuad = 2 };

template <int F>
__global__ void __launch_bounds__(256) hash_encode_fwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ table, int n_levels,
        uint32_t table_size, const int* __restrict__ res, float mn0, float mn1, float mn2, float len0,
        float len1, float len2, int variant, int read_bf16, float* __restrict__ out) {
    const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= n_pts * n_levels) return;
    const int64_t b = idx / n_levels;
    const int l = static_cast<int>(idx - b * n_levels);
    const int r = res[l];
    const float rf = static_cast<float>(r);

    // same rounding steps as the reference: normalise, scale, floor, clip;
    // the _rn intrinsics keep nvcc from contracting them into FMAs
    const float px = __fmul_rn(__fdiv_rn(__fsub_rn(xyz[3 * b + 0], mn0), len0), rf);
    const float py = __fmul_rn(__fdiv_rn(__fsub_rn(xyz[3 * b + 1], mn1), len1), rf);
    const float pz = __fmul_rn(__fdiv_rn(__fsub_rn(xyz[3 * b + 2], mn2), len2), rf);
    const int x0 = min(max(static_cast<int>(floorf(px)), 0), r - 1);
    const int y0 = min(max(static_cast<int>(floorf(py)), 0), r - 1);
    const int z0 = min(max(static_cast<int>(floorf(pz)), 0), r - 1);
    const float fx = __fsub_rn(px, static_cast<float>(x0));
    const float fy = __fsub_rn(py, static_cast<float>(y0));
    const float fz = __fsub_rn(pz, static_cast<float>(z0));
    const float wx[2] = {__fsub_rn(1.f, fx), fx};
    const float wy[2] = {__fsub_rn(1.f, fy), fy};
    const float wz[2] = {__fsub_rn(1.f, fz), fz};

    const uint32_t mask = table_size - 1u;
    const int64_t n1 = r + 1;
    const bool dense = n1 * n1 * n1 <= static_cast<int64_t>(table_size);
    const uint32_t ux = static_cast<uint32_t>(x0), uy = static_cast<uint32_t>(y0), uz = static_cast<uint32_t>(z0);
    const float* tab = table + static_cast<int64_t>(l) * table_size * F;

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;

    // corners in _CORNER_OFFSETS order: z outer, then x, then y
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const uint32_t cz = c >> 2, cx = (c >> 1) & 1u, cy = c & 1u;
        uint32_t e;
        if (dense) {
            const uint32_t nn = static_cast<uint32_t>(n1);
            e = (ux + cx) * (nn * nn) + (uy + cy) * nn + uz + cz;
        } else if (variant == kQuad) {
            const uint32_t qb = ((ux + cx) * kPrime1 + uy * kQuadSY + uz) & mask;
            e = (qb + cy * kQuadSY + cz) & mask;
        } else if (variant == kPair) {
            const uint32_t base = (((ux + cx) ^ ((uy + cy) * kPrime1)) + uz) & mask;
            e = (base + cz) & mask;
        } else {
            e = ((ux + cx) ^ ((uy + cy) * kPrime1) ^ ((uz + cz) * kPrime2)) & mask;
        }
        const float w = __fmul_rn(__fmul_rn(wx[cx], wy[cy]), wz[cz]);
        const float* entry = tab + static_cast<int64_t>(e) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) {
            const float v = read_bf16 ? round_bf16(entry[f]) : entry[f];
            acc[f] = __fadd_rn(acc[f], __fmul_rn(v, w));
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
