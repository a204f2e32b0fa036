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
// What bounds it on the H100: ~20 bytes read and 16 written per stream
// row, a few MB a step, so latency: how long the longest chain of
// dependent steps is. The training step has no per-ray cap (512 fixed
// steps), so a few rays carry hundreds of samples. Design: one warp a ray
// (a group of kGroup lanes), the lanes on kGroup consecutive samples, so
// every load is coalesced and a ray of n samples takes ceil(n / 32) chunks
// of log2(32) shuffle steps, not n dependent steps:
// - forward: T_i is a product scan of the o_i across the lanes
//   (seg_scan::product_scan), times the carry of the chunks before;
// - backward: R_{i-1} = alpha_i G_i + o_i R_i is an affine map of R_i, and
//   maps compose associatively, so a reverse scan (seg_scan::suffix_scan)
//   gives each lane the map from the chunk's right edge to its sample,
//   applied to the R carried in from the chunk to the right; the chunks
//   are walked from the segment's end;
// - the last chunk keeps its T_i, alpha_i and the rest in registers from
//   the forward to the backward walk (a ray of at most 32 samples reads
//   its rows once); the other chunks park T_i in the dsigma output and
//   read their rows again;
// - d_rgb leaves as whole runs of 3 kGroup floats, each lane taking the
//   weight of its float's sample by a shuffle.
// Tree order replaces the sequential order of the plain version (the JAX
// forward is itself an associative scan); no division by o_i.

#include "seg_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;  // lanes a ray

// One sample of a chunk: lane `lane` of the group on stream row i (rows at
// or past `end` are outside the segment and come out as alpha 0, o 1).
struct Sample {
    float z, s_raw, delta, ex, alpha, o;
};

template <int W>
__device__ __forceinline__ Sample load_sample(const float* __restrict__ sigma, const float* __restrict__ z,
                                              int64_t i, int64_t end, int add_inf_z, unsigned mask, int lane) {
    Sample p;
    const bool in = i < end;
    p.z = in ? z[i] : 0.f;
    float z_next = __shfl_down_sync(mask, p.z, 1, W);
    if (lane == W - 1 && i + 1 < end) z_next = z[i + 1];
    if (i + 1 < end) {
        const float d = __fsub_rn(z_next, p.z);
        p.delta = fabsf(d) < 1e-5f ? 0.f : d;
    } else {
        p.delta = add_inf_z ? 1e10f : 0.f;
    }
    p.s_raw = in ? sigma[i] : 0.f;
    const float s = fminf(fmaxf(p.s_raw, 0.f), 1e10f);
    p.ex = expf(__fmul_rn(-s, p.delta));
    p.alpha = in ? __fsub_rn(1.f, p.ex) : 0.f;
    p.o = in ? __fadd_rn(__fsub_rn(1.f, p.alpha), 1e-10f) : 1.f;
    return p;
}

template <int W>
__global__ void __launch_bounds__(kThreads) segment_march_bwd_kernel(
        const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ z,
        const int64_t* __restrict__ off, const int64_t* __restrict__ cnt, int n_rays, int64_t k_total,
        int add_inf_z, const float* __restrict__ bkg, int white_bkg, const float* __restrict__ g_rgb,
        const float* __restrict__ g_depth, const float* __restrict__ g_mask, float* __restrict__ d_sigma,
        float* __restrict__ d_rgb) {
    const int lane = threadIdx.x % W;
    const int64_t ray = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / W;
    // a group leaves as a whole: its lanes share the ray
    if (ray >= n_rays || cnt[ray] <= 0) return;
    const int64_t o = off[ray], e = off[ray] + cnt[ray];
    const int64_t start = o < k_total ? o : k_total;
    const int64_t end = e < k_total ? e : k_total;
    if (start >= end) return;
    const unsigned mask = seg_scan::group_mask<W>();
    const int n_chunks = static_cast<int>((end - start + W - 1) / W);

    // forward walk: T_i = carry x the product scan of the chunk's o
    float carry = 1.f, t = 1.f;
    Sample p{};
    for (int k = 0; k < n_chunks; ++k) {
        const int64_t i = start + static_cast<int64_t>(k) * W + lane;
        p = load_sample<W>(sigma, z, i, end, add_inf_z, mask, lane);
        const float incl = seg_scan::product_scan<W>(mask, lane, p.o);
        const float excl = __shfl_up_sync(mask, incl, 1, W);
        t = lane == 0 ? carry : __fmul_rn(carry, excl);
        if (k < n_chunks - 1) d_sigma[i] = t;  // parked for the backward walk
        carry = __fmul_rn(carry, __shfl_sync(mask, incl, W - 1, W));
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
    // backward walk, from the segment's end
    for (int k = n_chunks - 1; k >= 0; --k) {
        const int64_t base = start + static_cast<int64_t>(k) * W;
        const int64_t i = base + lane;
        const bool in = i < end;
        if (k < n_chunks - 1) {  // the last chunk is still in registers
            p = load_sample<W>(sigma, z, i, end, add_inf_z, mask, lane);
            t = d_sigma[i];
        }
        float G = 0.f;
        if (in) G = gm + p.z * gd + rgb[3 * i + 0] * gr + rgb[3 * i + 1] * gg + rgb[3 * i + 2] * gb;
        const seg_scan::Affine f = {in ? __fmul_rn(p.alpha, G) : 0.f, p.o};
        const seg_scan::Affine incl = seg_scan::suffix_scan<W>(mask, lane, f);
        // R_i: the maps of the lanes above this one, applied to the carry
        seg_scan::Affine above = {__shfl_down_sync(mask, incl.a, 1, W), __shfl_down_sync(mask, incl.o, 1, W)};
        if (lane == W - 1) above = {0.f, 1.f};
        const float r_i = seg_scan::apply(above, R);
        R = seg_scan::apply({__shfl_sync(mask, incl.a, 0, W), __shfl_sync(mask, incl.o, 0, W)}, R);
        if (in) {
            const float d_alpha = t * (G - r_i);
            d_sigma[i] = (p.s_raw > 0.f && p.s_raw < 1e10f) ? d_alpha * p.delta * p.ex : 0.f;
        }
        // d_rgb[3 base + e] for e = q W + lane: sample e / 3, colour e % 3
        const float w = t * p.alpha;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const int e = q * W + lane;
            const float ws = __shfl_sync(mask, w, e / 3, W);
            const int c = e - (e / 3) * 3;
            if (base + e / 3 < end) d_rgb[3 * base + e] = ws * (c == 0 ? gr : (c == 1 ? gg : gb));
        }
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
    constexpr int kRaysPerBlock = kThreads / kGroup;
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    segment_march_bwd_kernel<kGroup><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(sigma), static_cast<const float*>(rgb), static_cast<const float*>(z),
        static_cast<const int64_t*>(off), static_cast<const int64_t*>(cnt), n_rays, k_total, add_inf_z,
        static_cast<const float*>(bkg), white_bkg, static_cast<const float*>(g_rgb),
        static_cast<const float*>(g_depth), static_cast<const float*>(g_mask), static_cast<float*>(d_sigma),
        static_cast<float*>(d_rgb));
    return static_cast<int>(cudaGetLastError());
}
