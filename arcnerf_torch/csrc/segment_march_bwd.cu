// Kernel F: alpha compositing over the compacted sample stream, backward.
//
// The gradient of segment_march of arcnerf_tpu/render/ray_helper.py (what
// jax.grad takes through its segmented product scan and stream-wide
// cumsums) with respect to sigma and rgb, given the gradients of the
// per-ray rgb, depth and mask. Each ray r owns the stream rows
// [off_r, off_r + cnt_r) clipped to the stream length, exactly as kernel C
// reads them; padding rows, whose ray id is arbitrary, are never touched
// (the caller zeroes the outputs). Per ray, with o_i = 1 - alpha_i + 1e-10,
// T_i the exclusive product of the o_j and G_i = dM + z_i dD + c_i . dRGB
// (minus sum(dRGB) under white_bkg):
//   R_last = bkg . dRGB (the background term through trans_end),
//   R_{i-1} = alpha_i G_i + o_i R_i, walking back,
//   dalpha_i = T_i (G_i - R_i),
//   dsigma_i = dalpha_i delta_i exp(-s_i delta_i) where relu(sigma) is
//              active and below the 1e10 clamp, else 0,
//   drgb_i = T_i alpha_i dRGB.
// This form never divides by o_i (which can be ~1e-10).
//
// What bounds it on the H100: like kernel C, ~20 bytes read and 16 written
// per stream row, a few MB per step, so launch and latency bound. Design:
// one thread per ray; a forward walk parks T_i in the dsigma output, and a
// backward walk reads it back and overwrites it with dsigma_i. Nothing
// leaves the thread but the per-sample outputs.

#include "common.cuh"

namespace {

__device__ __forceinline__ float delta_at(const float* __restrict__ z, int64_t i, int64_t end, int add_inf_z) {
    if (i + 1 < end) {
        const float d = __fsub_rn(z[i + 1], z[i]);
        return fabsf(d) < 1e-5f ? 0.f : d;
    }
    return add_inf_z ? 1e10f : 0.f;
}

__global__ void __launch_bounds__(256) segment_march_bwd_kernel(
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

// sigma (K,), rgb (K, 3), z (K,) f32; off/cnt (n_rays,) int64; bkg
// (n_rays, 3) f32 or null; g_rgb (n_rays, 3), g_depth/g_mask (n_rays,) f32;
// d_sigma (K,) and d_rgb (K, 3) f32, zeroed by the caller.
extern "C" int arcnerf_segment_march_bwd(const void* sigma, const void* rgb, const void* z, const void* off,
                                         const void* cnt, int n_rays, long long k_total, int add_inf_z,
                                         const void* bkg, int white_bkg, const void* g_rgb, const void* g_depth,
                                         const void* g_mask, void* d_sigma, void* d_rgb, void* stream) {
    if (n_rays <= 0 || k_total < 0) return ARCNERF_BAD_ARGUMENT;
    const int threads = 256;
    const int blocks = (n_rays + threads - 1) / threads;
    segment_march_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigma), static_cast<const float*>(rgb), static_cast<const float*>(z),
        static_cast<const int64_t*>(off), static_cast<const int64_t*>(cnt), n_rays, k_total, add_inf_z,
        static_cast<const float*>(bkg), white_bkg, static_cast<const float*>(g_rgb),
        static_cast<const float*>(g_depth), static_cast<const float*>(g_mask), static_cast<float*>(d_sigma),
        static_cast<float*>(d_rgb));
    return static_cast<int>(cudaGetLastError());
}
