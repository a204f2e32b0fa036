// Kernel C: alpha compositing over the compacted sample stream, forward.
//
// Replaces segment_march of arcnerf_tpu/render/ray_helper.py (the
// associative segmented-product scan plus global-cumsum segment sums that
// XLA lowers for the TPU). Each ray r owns the stream rows
// [off_r, off_r + cnt_r) (clipped to the stream length); rows past a ray's
// segment - including budget padding, whose ray id is arbitrary - are never
// read. Per sample: delta to the next sample of the same ray (crushed to 0
// below 1e-5), a tail delta of 0 or 1e10 under add_inf_z,
// alpha = 1 - exp(-min(relu(sigma), 1e10) * delta), exclusive
// transmittance as the running product of (1 - alpha + 1e-10), and the sums
// of weight, weight * z and weight * rgb; then trans_end and the
// background term.
//
// What bounds it on the H100: ~20 bytes read per stream row and 24 written
// per ray - memory traffic of a few MB per 16384-ray chunk, so launch and
// latency bound at serving sizes. Design: one thread per ray walks its own
// segment sequentially (the segmented scan becomes a register loop, with
// no second pass and no global prefix sum), so per-ray sums carry no
// cancellation error from a stream-wide cumsum.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) segment_march_fwd_kernel(
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

// sigma (K,), rgb (K, 3), z (K,) f32; off/cnt (n_rays,) int64; bkg
// (n_rays, 3) f32 or null; outputs rgb (n_rays, 3), depth/mask/trans_end
// (n_rays,) f32.
extern "C" int arcnerf_segment_march_fwd(const void* sigma, const void* rgb, const void* z, const void* off,
                                         const void* cnt, int n_rays, long long k_total, int add_inf_z,
                                         const void* bkg, int white_bkg, void* out_rgb, void* out_depth,
                                         void* out_mask, void* out_trans_end, void* stream) {
    if (n_rays <= 0 || k_total < 0) return ARCNERF_BAD_ARGUMENT;
    const int threads = 256;
    const int blocks = (n_rays + threads - 1) / threads;
    segment_march_fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigma), static_cast<const float*>(rgb), static_cast<const float*>(z),
        static_cast<const int64_t*>(off), static_cast<const int64_t*>(cnt), n_rays, k_total, add_inf_z,
        static_cast<const float*>(bkg), white_bkg, static_cast<float*>(out_rgb), static_cast<float*>(out_depth),
        static_cast<float*>(out_mask), static_cast<float*>(out_trans_end));
    return static_cast<int>(cudaGetLastError());
}
