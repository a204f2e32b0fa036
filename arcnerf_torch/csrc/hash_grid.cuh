// Corner entries and trilinear weights of one (point, level) of the
// multi-resolution hash grid, shared by kernel B (encode) and kernel E
// (table scatter) so that the backward adds into exactly the entries the
// forward read.
//
// The numbers are those of HashGridEmbedder's CPU element path
// (_gather_cols_f32): normalise, scale, floor and clip in the same rounding
// steps (the _rn intrinsics keep nvcc from contracting them into FMAs), the
// dense index or the quad / pair / instant-ngp hash with uint32 wrapping
// multiplies and & (T-1), the 8 weights in _CORNER_OFFSETS order
// (z outer, then x, then y).
#pragma once

#include "common.cuh"

namespace hash_grid {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kQuadSY = 31u;
enum Variant { kNgp = 0, kPair = 1, kQuad = 2 };

// The point's position in the volume, in [0, 1] inside it: (x - mn) / len
// per axis, the first rounding steps of corners(). A caller that visits
// many levels of one point computes it once.
__device__ __forceinline__ float3 normalize(float x, float y, float z, float mn0, float mn1, float mn2, float len0,
                                            float len1, float len2) {
    return make_float3(__fdiv_rn(__fsub_rn(x, mn0), len0), __fdiv_rn(__fsub_rn(y, mn1), len1),
                       __fdiv_rn(__fsub_rn(z, mn2), len2));
}

// n: the point as normalize() gives it; r: the level's resolution. Fills
// entry[c] (row in the level's table) and w[c] per corner c.
__device__ __forceinline__ void corners(float3 n, int r, uint32_t table_size, int variant, uint32_t (&entry)[8],
                                        float (&w)[8]) {
    const float rf = static_cast<float>(r);
    const float px = __fmul_rn(n.x, rf);
    const float py = __fmul_rn(n.y, rf);
    const float pz = __fmul_rn(n.z, rf);
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
        entry[c] = e;
        w[c] = __fmul_rn(__fmul_rn(wx[cx], wy[cy]), wz[cz]);
    }
}

// xyz: the point; r: the level's resolution; mn/len: volume corner and side
// lengths. The same entries and weights as above, from the raw point.
__device__ __forceinline__ void corners(float x, float y, float z, int r, float mn0, float mn1, float mn2,
                                        float len0, float len1, float len2, uint32_t table_size, int variant,
                                        uint32_t (&entry)[8], float (&w)[8]) {
    corners(normalize(x, y, z, mn0, mn1, mn2, len0, len1, len2), r, table_size, variant, entry, w);
}

}  // namespace hash_grid
