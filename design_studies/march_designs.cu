// Design variants of kernel F (compositing backward), for
// design_studies/march_designs.py: the designs the kernel in
// arcnerf_torch/csrc/segment_march_bwd.cu was chosen against. Not part of
// the port's kernels: nothing in the package launches these.
//
//   0 thread a ray     the earlier kernel: one thread walks its ray's
//                      segment forward, then back, one sample a step
//   1 16 lanes a ray   the package's kernel on groups of 16 lanes, two
//                      rays a warp (its template, included from the package)
//   2 8 lanes a ray    the same on groups of 8 lanes, four rays a warp

#include "../arcnerf_torch/csrc/segment_march_bwd.cu"

namespace {

__device__ __forceinline__ float delta_at(const float* __restrict__ z, int64_t i, int64_t end, int add_inf_z) {
    if (i + 1 < end) {
        const float d = __fsub_rn(z[i + 1], z[i]);
        return fabsf(d) < 1e-5f ? 0.f : d;
    }
    return add_inf_z ? 1e10f : 0.f;
}

__global__ void __launch_bounds__(256) thread_per_ray(
        const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ z,
        const int64_t* __restrict__ off, const int64_t* __restrict__ cnt, int n_rays, int64_t k_total,
        int add_inf_z, const float* __restrict__ bkg, int white_bkg, const float* __restrict__ g_rgb,
        const float* __restrict__ g_depth, const float* __restrict__ g_mask, float* __restrict__ d_sigma,
        float* __restrict__ d_rgb) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays || cnt[ray] <= 0) return;
    const int64_t o = off[ray], e = off[ray] + cnt[ray];
    const int64_t start = o < k_total ? o : k_total;
    const int64_t end = e < k_total ? e : k_total;

    // forward walk: exclusive transmittance T_i, parked in d_sigma[i]
    float trans = 1.f;
    for (int64_t i = start; i < end; ++i) {
        d_sigma[i] = trans;
        const float s = fminf(fmaxf(sigma[i], 0.f), 1e10f);
        const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-s, delta_at(z, i, end, add_inf_z))));
        trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    }

    const float gr = g_rgb[3 * ray + 0], gg = g_rgb[3 * ray + 1], gb = g_rgb[3 * ray + 2];
    const float gd = g_depth[ray];
    float gm = g_mask[ray];
    float R = 0.f;
    if (bkg != nullptr) {
        R = bkg[3 * ray + 0] * gr + bkg[3 * ray + 1] * gg + bkg[3 * ray + 2] * gb;
    } else if (white_bkg) {
        gm -= gr + gg + gb;
    }
    // backward walk
    for (int64_t i = end - 1; i >= start; --i) {
        const float t = d_sigma[i];
        const float delta = delta_at(z, i, end, add_inf_z);
        const float sr = sigma[i];
        const float s = fminf(fmaxf(sr, 0.f), 1e10f);
        const float ex = expf(__fmul_rn(-s, delta));
        const float alpha = __fsub_rn(1.f, ex);
        const float G = gm + z[i] * gd + rgb[3 * i + 0] * gr + rgb[3 * i + 1] * gg + rgb[3 * i + 2] * gb;
        const float d_alpha = t * (G - R);
        d_sigma[i] = (sr > 0.f && sr < 1e10f) ? d_alpha * delta * ex : 0.f;
        const float w = t * alpha;
        d_rgb[3 * i + 0] = w * gr;
        d_rgb[3 * i + 1] = w * gg;
        d_rgb[3 * i + 2] = w * gb;
        R = alpha * G + __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f) * R;
    }
}

}  // namespace

// design: 0 thread a ray, 1 groups of 16 lanes, 2 groups of 8; the rest as
// arcnerf_segment_march_bwd.
extern "C" int design_segment_march_bwd(int design, const void* sigma, const void* rgb, const void* z,
                                        const void* off, const void* cnt, int n_rays, long long k_total,
                                        int add_inf_z, const void* bkg, int white_bkg, const void* g_rgb,
                                        const void* g_depth, const void* g_mask, void* d_sigma, void* d_rgb,
                                        void* stream) {
    if (n_rays <= 0 || k_total < 0 || design < 0 || design > 2) return ARCNERF_BAD_ARGUMENT;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int lanes = design == 0 ? 1 : (design == 1 ? 16 : 8);
    const int rays_a_block = kThreads / lanes;
    const int blocks = (n_rays + rays_a_block - 1) / rays_a_block;
    const auto* sp = static_cast<const float*>(sigma);
    const auto* cp = static_cast<const float*>(rgb);
    const auto* zp = static_cast<const float*>(z);
    const auto* op = static_cast<const int64_t*>(off);
    const auto* np = static_cast<const int64_t*>(cnt);
    const auto* bp = static_cast<const float*>(bkg);
    const auto* gr = static_cast<const float*>(g_rgb);
    const auto* gd = static_cast<const float*>(g_depth);
    const auto* gm = static_cast<const float*>(g_mask);
    auto* ds = static_cast<float*>(d_sigma);
    auto* dr = static_cast<float*>(d_rgb);
    if (design == 0) {
        thread_per_ray<<<blocks, kThreads, 0, s>>>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z, bp, white_bkg, gr,
                                                   gd, gm, ds, dr);
    } else if (design == 1) {
        segment_march_bwd_kernel<16><<<blocks, kThreads, 0, s>>>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z, bp,
                                                                 white_bkg, gr, gd, gm, ds, dr);
    } else {
        segment_march_bwd_kernel<8><<<blocks, kThreads, 0, s>>>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z, bp,
                                                                white_bkg, gr, gd, gm, ds, dr);
    }
    return static_cast<int>(cudaGetLastError());
}
