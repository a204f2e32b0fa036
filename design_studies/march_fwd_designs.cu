// Design variants of kernel C (compositing forward), for
// design_studies/march_designs.py: what the kernel in
// arcnerf_torch/csrc/segment_march.cu (a group of 32 or 8 lanes a ray,
// timed there through its own entry point) was chosen against. Not part of
// the port's kernels: nothing in the package launches these.
//
//   group 0        the earlier design, a thread a ray: one thread walks its
//                  ray's segment, one dependent sample a step, summing in
//                  the plain version's order
//   group 16, 4    the package's kernel on groups of 16 or 4 lanes a ray
//                  (its template, included from the package)

#include "../arcnerf_torch/csrc/segment_march.cu"

namespace {

__global__ void __launch_bounds__(256) thread_per_ray_fwd(
        const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ z,
        const int64_t* __restrict__ off, const int64_t* __restrict__ cnt, int n_rays, int64_t k_total,
        int add_inf_z, const float* __restrict__ bkg, int white_bkg, float* __restrict__ out_rgb,
        float* __restrict__ out_depth, float* __restrict__ out_mask, float* __restrict__ out_trans_end) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays) return;
    const int64_t o = off[ray], e = off[ray] + cnt[ray];
    const int64_t start = o < k_total ? o : k_total;
    const int64_t end = e < k_total ? e : k_total;
    float trans = 1.f, sw = 0.f, swz = 0.f, sr = 0.f, sg = 0.f, sb = 0.f;
    for (int64_t i = start; i < end; ++i) {
        const float zi = z[i];
        float delta;
        if (i + 1 < end) {
            delta = __fsub_rn(z[i + 1], zi);
            if (fabsf(delta) < 1e-5f) delta = 0.f;
        } else {
            delta = add_inf_z ? 1e10f : 0.f;
        }
        const float s = fminf(fmaxf(sigma[i], 0.f), 1e10f);
        const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-s, delta)));
        const float w = __fmul_rn(trans, alpha);
        sw = __fadd_rn(sw, w);
        swz = __fadd_rn(swz, __fmul_rn(w, zi));
        sr = __fadd_rn(sr, __fmul_rn(w, rgb[3 * i + 0]));
        sg = __fadd_rn(sg, __fmul_rn(w, rgb[3 * i + 1]));
        sb = __fadd_rn(sb, __fmul_rn(w, rgb[3 * i + 2]));
        trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    }
    if (cnt[ray] <= 0) trans = 1.f;
    if (bkg != nullptr) {
        sr = __fadd_rn(sr, __fmul_rn(trans, bkg[3 * ray + 0]));
        sg = __fadd_rn(sg, __fmul_rn(trans, bkg[3 * ray + 1]));
        sb = __fadd_rn(sb, __fmul_rn(trans, bkg[3 * ray + 2]));
    } else if (white_bkg) {
        const float fill = __fsub_rn(1.f, sw);
        sr = __fadd_rn(sr, fill);
        sg = __fadd_rn(sg, fill);
        sb = __fadd_rn(sb, fill);
    }
    out_rgb[3 * ray + 0] = sr;
    out_rgb[3 * ray + 1] = sg;
    out_rgb[3 * ray + 2] = sb;
    out_depth[ray] = swz;
    out_mask[ray] = sw;
    out_trans_end[ray] = trans;
}

}  // namespace

// As arcnerf_segment_march_fwd, with group 0 (a thread a ray), 16 or 4.
extern "C" int design_segment_march_fwd(const void* sigma, const void* rgb, const void* z, const void* off,
                                        const void* cnt, int n_rays, long long k_total, int add_inf_z,
                                        const void* bkg, int white_bkg, int group, void* out_rgb,
                                        void* out_depth, void* out_mask, void* out_trans_end, void* stream) {
    if (n_rays <= 0 || k_total < 0) return ARCNERF_BAD_ARGUMENT;
    const auto* sp = static_cast<const float*>(sigma);
    const auto* cp = static_cast<const float*>(rgb);
    const auto* zp = static_cast<const float*>(z);
    const auto* op = static_cast<const int64_t*>(off);
    const auto* np = static_cast<const int64_t*>(cnt);
    const auto* bp = static_cast<const float*>(bkg);
    auto* orgb = static_cast<float*>(out_rgb);
    auto* od = static_cast<float*>(out_depth);
    auto* om = static_cast<float*>(out_mask);
    auto* ot = static_cast<float*>(out_trans_end);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (group) {
        case 0:
            thread_per_ray_fwd<<<(n_rays + 255) / 256, 256, 0, s>>>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z,
                                                                   bp, white_bkg, orgb, od, om, ot);
            break;
        case 16: launch<16>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z, bp, white_bkg, orgb, od, om, ot, s); break;
        case 4: launch<4>(sp, cp, zp, op, np, n_rays, k_total, add_inf_z, bp, white_bkg, orgb, od, om, ot, s); break;
        default: return ARCNERF_BAD_ARGUMENT;
    }
    return static_cast<int>(cudaGetLastError());
}
