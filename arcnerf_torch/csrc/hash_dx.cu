// Kernels K and L: the multi-resolution hash grid's input gradient and its
// backward, for an SDF's normal (d sdf / d xyz) and the eikonal loss on it.
//
// Replaces no TPU kernel: the JAX package takes the same derivatives with
// jax.grad through the unfused element path of HashGridEmbedder
// (arcnerf_tpu/models/base_modules/encoding.py, needs_input_grad). The
// plain versions are hash_encode_dx_reference and hash_dx_bwd_reference
// (arcnerf_torch/models/base_modules/encoding.py).
//
// K (hash_dx_kernel): for every point b, with g = dL/d(encoding) (N, L F)
// and the table read as kernel B reads it (bf16-rounded entries),
//   dx[b, a] = sum_l (res_l / len_a) sum_c dw_c,a sum_f g[b, l F + f] T[e_c, f]
// where dw_c,a is the derivative of corner c's trilinear weight with
// respect to the point's fraction along axis a (hash_grid::corner_grads).
// L (hash_dx_bwd_kernel): for the gradient g_dx (N, 3) of dx, with
// u_c = sum_a g_dx[b, a] (res_l / len_a) dw_c,a per point, level and corner,
//   d_table[e_c, f] += u_c g[b, l F + f]   (straight through the bf16 read)
//   d_g[b, l F + f]  = sum_c u_c T[e_c, f]
// No gradient goes to the points: they are not learned.
//
// What bounds them on the H100: the same random 4F-byte table reads as B
// (8 corners x 16 levels a point) for K and for L's gather, and the same
// atomic adds as E for L's scatter; the derivative weights add arithmetic
// only. Design:
// - K is kernel B's form: a block takes 32 consecutive points and one warp
//   a level (levels in chunks of 16), the points normalised once into
//   shared memory, the 8 corners' loads in flight before the sums; each
//   lane keeps its level's three partial sums, and the block adds the
//   levels of each point in level order through shared memory and writes
//   its 32 x 3 outputs;
// - L is kernel E's form: blocks over (256 consecutive points, level),
//   level slowest, so one level's table is hot in L2; the scatter goes
//   through E's warp aggregation and vector atomics (hash_scatter.cuh,
//   the z-neighbour corners sharing a slot for F <= 2), and the same lane
//   gathers its 8 corners for d_g, written once a point and level.
// Sums in K run in corner, then level order; L's table sums land in an
// order that changes from run to run, as E's do.

#include "hash_grid.cuh"
#include "hash_scatter.cuh"

namespace {

constexpr int kPoints = 32;  // K: points a block, one a lane
constexpr int kWarps = 16;   // K: levels a block takes at once, one a warp
constexpr int kThreads = 256;  // L

template <int F>
__device__ __forceinline__ void load_entry(const float* __restrict__ tab, uint32_t e, int read_bf16, float (&v)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
        const float t = __ldg(tab + static_cast<int64_t>(e) * F + f);
        v[f] = read_bf16 ? round_bf16(t) : t;
    }
}

template <int F>
__global__ void __launch_bounds__(kPoints * kWarps) hash_dx_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ table,
        const float* __restrict__ g, int n_levels, uint32_t table_size, const int* __restrict__ res, float mn0,
        float mn1, float mn2, float len0, float len1, float len2, int variant, int read_bf16,
        float* __restrict__ dx) {
    __shared__ float3 norm[kPoints];
    __shared__ float part[kWarps][kPoints][3];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPoints;
    const int n_here = static_cast<int>(min(static_cast<int64_t>(kPoints), n_pts - p0));
    if (static_cast<int>(threadIdx.x) < n_here) {
        const float* p = xyz + 3 * (p0 + threadIdx.x);
        norm[threadIdx.x] = hash_grid::normalize(p[0], p[1], p[2], mn0, mn1, mn2, len0, len1, len2);
    }
    __syncthreads();
    const float len[3] = {len0, len1, len2};
    float acc = 0.f;  // thread t < 32 x 3: point t / 3's axis t % 3, summed over the levels
    const int row = n_levels * F;
    for (int l0 = 0; l0 < n_levels; l0 += kWarps) {
        const int chunk = min(kWarps, n_levels - l0);
        const int l = l0 + warp;
        if (warp < chunk && lane < n_here) {
            uint32_t entry[8];
            float dw[8][3];
            hash_grid::corner_grads(norm[lane], res[l], table_size, variant, entry, dw);
            const float* tab = table + static_cast<int64_t>(l) * table_size * F;
            float v[8][F];
#pragma unroll
            for (int c = 0; c < 8; ++c) load_entry<F>(tab, entry[c], read_bf16, v[c]);
            float gf[F];
            const float* gr = g + (p0 + lane) * row + l * F;
#pragma unroll
            for (int f = 0; f < F; ++f) gf[f] = gr[f];
            float gp[3] = {0.f, 0.f, 0.f};
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                float t = 0.f;
#pragma unroll
                for (int f = 0; f < F; ++f) t = __fadd_rn(t, __fmul_rn(v[c][f], gf[f]));
#pragma unroll
                for (int a = 0; a < 3; ++a) gp[a] = __fadd_rn(gp[a], __fmul_rn(t, dw[c][a]));
            }
            const float rf = static_cast<float>(res[l]);
#pragma unroll
            for (int a = 0; a < 3; ++a) part[warp][lane][a] = __fmul_rn(gp[a], __fdiv_rn(rf, len[a]));
        }
        __syncthreads();
        if (static_cast<int>(threadIdx.x) < n_here * 3) {
            const int pt = threadIdx.x / 3, a = threadIdx.x % 3;
            for (int k = 0; k < chunk; ++k) acc = __fadd_rn(acc, part[k][pt][a]);
        }
        __syncthreads();
    }
    if (static_cast<int>(threadIdx.x) < n_here * 3) dx[p0 * 3 + threadIdx.x] = acc;
}

template <int F>
__global__ void __launch_bounds__(kThreads) hash_dx_bwd_kernel(
        const float* __restrict__ xyz, int64_t n_pts, const float* __restrict__ table,
        const float* __restrict__ g, const float* __restrict__ g_dx, int n_levels, uint32_t table_size,
        const int* __restrict__ res, float mn0, float mn1, float mn2, float len0, float len1, float len2,
        int variant, int read_bf16, float* __restrict__ d_table, float* __restrict__ d_g) {
    const int l = blockIdx.y;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    // whole warps past the end leave; the last warp's lanes past the end
    // stay for the warp-wide sums, on the last point with g = 0
    if (i - (threadIdx.x & 31) >= n_pts) return;
    const bool live = i < n_pts;
    const int64_t b = live ? i : n_pts - 1;
    const int64_t row = static_cast<int64_t>(n_levels) * F;

    float gf[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gf[f] = live ? g[b * row + l * F + f] : 0.f;
    const float rf = static_cast<float>(res[l]);
    const float q[3] = {__fmul_rn(g_dx[3 * b + 0], __fdiv_rn(rf, len0)),
                        __fmul_rn(g_dx[3 * b + 1], __fdiv_rn(rf, len1)),
                        __fmul_rn(g_dx[3 * b + 2], __fdiv_rn(rf, len2))};
    uint32_t entry[8];
    float dw[8][3];
    hash_grid::corner_grads(hash_grid::normalize(xyz[3 * b], xyz[3 * b + 1], xyz[3 * b + 2], mn0, mn1, mn2, len0,
                                                 len1, len2),
                            res[l], table_size, variant, entry, dw);
    float u[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
        u[c] = __fadd_rn(__fadd_rn(__fmul_rn(dw[c][0], q[0]), __fmul_rn(dw[c][1], q[1])), __fmul_rn(dw[c][2], q[2]));

    // the gather: d_g = sum_c u_c T[e_c]
    const float* tab = table + static_cast<int64_t>(l) * table_size * F;
    float v[8][F];
#pragma unroll
    for (int c = 0; c < 8; ++c) load_entry<F>(tab, entry[c], read_bf16, v[c]);
    if (live) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) s = __fadd_rn(s, __fmul_rn(u[c], v[c][f]));
            d_g[b * row + l * F + f] = s;
        }
    }

    // the scatter: d_table[e_c] += u_c g, as kernel E adds w_c g
    float* dst = d_table + static_cast<int64_t>(l) * table_size * F;
    if constexpr (F <= 2) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint32_t ea = entry[p], eb = entry[p + 4];
            const bool joint = (ea >> 1) == (eb >> 1);
            float ta[F], tb[F], va[2 * F] = {}, vb[2 * F] = {};
#pragma unroll
            for (int f = 0; f < F; ++f) {
                ta[f] = __fmul_rn(u[p], gf[f]);
                tb[f] = __fmul_rn(u[p + 4], gf[f]);
            }
            hash_scatter::add_half<F>(ea, ta, va);
            if (joint) {
                hash_scatter::add_half<F>(eb, tb, va);
            } else {
                hash_scatter::add_half<F>(eb, tb, vb);
            }
            if (hash_scatter::warp_group_sum<2 * F>(ea >> 1, va) && hash_scatter::any_nonzero(va))
                hash_scatter::add_vector(dst + static_cast<int64_t>(ea >> 1) * 2 * F, va);
            if (hash_scatter::warp_group_sum<2 * F>(eb >> 1, vb) && hash_scatter::any_nonzero(vb))
                hash_scatter::add_vector(dst + static_cast<int64_t>(eb >> 1) * 2 * F, vb);
        }
    } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float t[F];
#pragma unroll
            for (int f = 0; f < F; ++f) t[f] = __fmul_rn(u[c], gf[f]);
            if (hash_scatter::warp_group_sum<F>(entry[c], t) && hash_scatter::any_nonzero(t))
                hash_scatter::add_vector(dst + static_cast<int64_t>(entry[c]) * F, t);
        }
    }
}

bool bad_args(long long n_pts, int n_levels, int log2_table, int variant) {
    return n_pts <= 0 || n_levels <= 0 || n_levels > 65535 || log2_table < 1 || log2_table > 30 || variant < 0 ||
           variant > 2;
}

template <int F>
int launch_dx(const float* xyz, int64_t n_pts, const float* table, const float* g, int n_levels, uint32_t t,
              const int* res, const float* mn, const float* len, int variant, int read_bf16, float* dx,
              cudaStream_t s) {
    const int64_t blocks = (n_pts + kPoints - 1) / kPoints;
    if (blocks > 0x7fffffff) return ARCNERF_BAD_ARGUMENT;
    hash_dx_kernel<F><<<static_cast<unsigned int>(blocks), kPoints * kWarps, 0, s>>>(
        xyz, n_pts, table, g, n_levels, t, res, mn[0], mn[1], mn[2], len[0], len[1], len[2], variant, read_bf16, dx);
    return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_bwd(const float* xyz, int64_t n_pts, const float* table, const float* g, const float* g_dx, int n_levels,
               uint32_t t, const int* res, const float* mn, const float* len, int variant, int read_bf16,
               float* d_table, float* d_g, cudaStream_t s) {
    const int64_t chunks = (n_pts + kThreads - 1) / kThreads;
    if (chunks > 0x7fffffff) return ARCNERF_BAD_ARGUMENT;
    const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(n_levels));
    hash_dx_bwd_kernel<F><<<grid, kThreads, 0, s>>>(xyz, n_pts, table, g, g_dx, n_levels, t, res, mn[0], mn[1], mn[2],
                                                    len[0], len[1], len[2], variant, read_bf16, d_table, d_g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz (n_pts, 3) f32; table (n_levels, 2^log2_table, n_feat) f32; g
// (n_pts, n_levels * n_feat) f32, dL/d(encoding); res (n_levels,) int32 on
// the device; aabb_min/aabb_len (3,) f32 on the host; variant 0 ngp / 1
// pair / 2 quad; dx (n_pts, 3) f32.
extern "C" int arcnerf_hash_dx(const void* xyz, long long n_pts, const void* table, const void* g, int n_levels,
                               int log2_table, int n_feat, const void* res, const float* aabb_min,
                               const float* aabb_len, int variant, int read_bf16, void* dx, void* stream) {
    if (bad_args(n_pts, n_levels, log2_table, variant)) return ARCNERF_BAD_ARGUMENT;
    const auto* xp = static_cast<const float*>(xyz);
    const auto* tp = static_cast<const float*>(table);
    const auto* gp = static_cast<const float*>(g);
    const auto* rp = static_cast<const int*>(res);
    auto* op = static_cast<float*>(dx);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t t = 1u << log2_table;
    switch (n_feat) {
        case 1: return launch_dx<1>(xp, n_pts, tp, gp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 2: return launch_dx<2>(xp, n_pts, tp, gp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 4: return launch_dx<4>(xp, n_pts, tp, gp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        case 8: return launch_dx<8>(xp, n_pts, tp, gp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, op, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}

// The same inputs and g_dx (n_pts, 3) f32, the gradient of dx; d_table
// (n_levels, 2^log2_table, n_feat) f32, zeroed by the caller (torch.zeros:
// 16-byte aligned), accumulated into; d_g (n_pts, n_levels * n_feat) f32.
extern "C" int arcnerf_hash_dx_bwd(const void* xyz, long long n_pts, const void* table, const void* g,
                                   const void* g_dx, int n_levels, int log2_table, int n_feat, const void* res,
                                   const float* aabb_min, const float* aabb_len, int variant, int read_bf16,
                                   void* d_table, void* d_g, void* stream) {
    if (bad_args(n_pts, n_levels, log2_table, variant)) return ARCNERF_BAD_ARGUMENT;
    const auto* xp = static_cast<const float*>(xyz);
    const auto* tp = static_cast<const float*>(table);
    const auto* gp = static_cast<const float*>(g);
    const auto* qp = static_cast<const float*>(g_dx);
    const auto* rp = static_cast<const int*>(res);
    auto* dt = static_cast<float*>(d_table);
    auto* dg = static_cast<float*>(d_g);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t t = 1u << log2_table;
    switch (n_feat) {
        case 1: return launch_bwd<1>(xp, n_pts, tp, gp, qp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, dt,
                                     dg, s);
        case 2: return launch_bwd<2>(xp, n_pts, tp, gp, qp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, dt,
                                     dg, s);
        case 4: return launch_bwd<4>(xp, n_pts, tp, gp, qp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, dt,
                                     dg, s);
        case 8: return launch_bwd<8>(xp, n_pts, tp, gp, qp, n_levels, t, rp, aabb_min, aabb_len, variant, read_bf16, dt,
                                     dg, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
