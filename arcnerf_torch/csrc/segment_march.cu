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
// transmittance T as the running product of o = 1 - alpha + 1e-10, and the
// sums of the weights w = T alpha, of w z and of w rgb; then trans_end (the
// product of every o) and the background term.
//
// What bounds it on the H100: ~20 bytes read per stream row and 24 written
// per ray, a few MB a call, so not the bytes but the longest chain of
// dependent steps. The training stream has no per-ray cap: ~78 % of its
// rays are empty and the rest carry ~73 samples (up to ~184), so one thread
// a ray walking its segment one dependent sample a step (the earlier
// design) leaves most lanes of a warp idle behind a few long rays. Serving
// caps a ray at 16 samples. Design, F's form (segment_march_bwd.cu) run
// forward only: a group of W lanes a ray, the lanes on W consecutive
// samples, so every load is coalesced and a ray of n samples takes
// ceil(n / W) chunks of log2(W) shuffle steps:
// - each chunk's samples come from seg_scan::load_row and finish_sample
//   (z_(i+1) by a shuffle, one extra load at the chunk's edge), the next
//   chunk's loads issued before this one's scan; T_i is the chunk's
//   product scan of o times the carry of the chunks before, and the carry
//   ends as trans_end;
// - each lane sums its own samples' w, w z and w rgb over the chunks, and
//   the group adds the lanes' sums once a ray (seg_scan::group_sum);
// - the caller picks W: 32 where no per-ray cap applies (training), 8
//   where the serving cap (16) keeps every ray short, so that a warp takes
//   four rays (a ray longer than W walks more chunks and stays right; 16
//   and 4 lanes were measured too and are kept in
//   design_studies/march_fwd_designs.cu). Empty rays leave after reading
//   off and cnt.
// Tree order replaces the sequential order of the plain version (the JAX
// forward is itself an associative scan); the _rn intrinsics keep nvcc from
// contracting into FMAs, so tests/test_torch_march_numerics.py models the
// order of every rounding.
// The alpha mode (mode 2, for an SDF's sections) reads each row's alpha
// from sigma and composites it as it is. The tail mode (a per-ray tail z,
// for the windowed tier's windows) gives each segment's last sample its
// delta to the ray's tail where that is finite, as the dense march on the
// pre-cap mask does, so consecutive windows telescope; elsewhere the tail
// rule of the mode holds. Both are template parameters, so the sigma mode
// compiles as before.

#include "seg_scan.cuh"

namespace {

constexpr int kThreads = 256;

// The colour of stream row i, zeros past the segment's end.
__device__ __forceinline__ float3 load_rgb(const float* __restrict__ rgb, int64_t i, int64_t end) {
    return i < end ? make_float3(rgb[3 * i + 0], rgb[3 * i + 1], rgb[3 * i + 2]) : make_float3(0.f, 0.f, 0.f);
}

template <int W, bool Alpha, bool Tail>
__global__ void __launch_bounds__(kThreads) segment_march_fwd_kernel(
        const float* __restrict__ sigma, const float* __restrict__ rgb, const float* __restrict__ z,
        const int64_t* __restrict__ off, const int64_t* __restrict__ cnt, int n_rays, int64_t k_total,
        int add_inf_z, const float* __restrict__ bkg, int white_bkg, const float* __restrict__ tail,
        float* __restrict__ out_rgb, float* __restrict__ out_depth, float* __restrict__ out_mask,
        float* __restrict__ out_trans_end) {
    const int lane = threadIdx.x % W;
    const int64_t ray = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / W;
    // a group leaves as a whole: its lanes share the ray
    if (ray >= n_rays) return;
    const int64_t c = cnt[ray], o = off[ray], e = o + c;
    const int64_t start = o < k_total ? o : k_total;
    const int64_t end = e < k_total ? e : k_total;
    const unsigned mask = seg_scan::group_mask<W>();

    float carry = 1.f, sw = 0.f, swz = 0.f, sr = 0.f, sg = 0.f, sb = 0.f;
    if (start < end) {
        const float t_ray = Tail ? tail[ray] : 0.f;  // an empty ray skips the walk and the group's sums
        // the chunk at `base` in registers, the next one's loads in flight
        seg_scan::Loaded row = seg_scan::load_row<W>(sigma, z, start + lane, end, lane);
        float3 col = load_rgb(rgb, start + lane, end);
        for (int64_t base = start; base < end; base += W) {
            const int64_t i = base + lane;
            const seg_scan::Loaded here = row;
            const float3 col_here = col;
            if (base + W < end) {
                row = seg_scan::load_row<W>(sigma, z, i + W, end, lane);
                col = load_rgb(rgb, i + W, end);
            }
            const seg_scan::Sample p = seg_scan::finish_sample<W, Alpha, Tail>(here, i, end, add_inf_z, mask, lane,
                                                                              t_ray);
            const float incl = seg_scan::product_scan<W>(mask, lane, p.o);
            const float excl = __shfl_up_sync(mask, incl, 1, W);
            const float t = lane == 0 ? carry : __fmul_rn(carry, excl);
            if (i < end) {
                const float w = __fmul_rn(t, p.alpha);
                sw = __fadd_rn(sw, w);
                swz = __fadd_rn(swz, __fmul_rn(w, p.z));
                sr = __fadd_rn(sr, __fmul_rn(w, col_here.x));
                sg = __fadd_rn(sg, __fmul_rn(w, col_here.y));
                sb = __fadd_rn(sb, __fmul_rn(w, col_here.z));
            }
            carry = __fmul_rn(carry, __shfl_sync(mask, incl, W - 1, W));
        }
        sw = seg_scan::group_sum<W>(mask, sw);
        swz = seg_scan::group_sum<W>(mask, swz);
        sr = seg_scan::group_sum<W>(mask, sr);
        sg = seg_scan::group_sum<W>(mask, sg);
        sb = seg_scan::group_sum<W>(mask, sb);
    }
    if (lane != 0) return;
    const float trans = c <= 0 ? 1.f : carry;
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

template <int W>
void launch(const float* sigma, const float* rgb, const float* z, const int64_t* off, const int64_t* cnt, int n_rays,
            int64_t k_total, int mode, const float* bkg, int white_bkg, const float* tail, float* out_rgb,
            float* out_depth, float* out_mask, float* out_trans_end, cudaStream_t s) {
    constexpr int kRaysPerBlock = kThreads / W;
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    if (mode == 2) {
        segment_march_fwd_kernel<W, true, false><<<blocks, kThreads, 0, s>>>(
            sigma, rgb, z, off, cnt, n_rays, k_total, 0, bkg, white_bkg, nullptr, out_rgb, out_depth, out_mask,
            out_trans_end);
    } else if (tail != nullptr) {
        segment_march_fwd_kernel<W, false, true><<<blocks, kThreads, 0, s>>>(
            sigma, rgb, z, off, cnt, n_rays, k_total, mode, bkg, white_bkg, tail, out_rgb, out_depth, out_mask,
            out_trans_end);
    } else {
        segment_march_fwd_kernel<W, false, false><<<blocks, kThreads, 0, s>>>(
            sigma, rgb, z, off, cnt, n_rays, k_total, mode, bkg, white_bkg, nullptr, out_rgb, out_depth, out_mask,
            out_trans_end);
    }
}

}  // namespace

// sigma (K,), rgb (K, 3), z (K,) f32; off/cnt (n_rays,) int64; mode: 0 or 1
// the sigma mode without or with add_inf_z, 2 the alpha mode (sigma holds
// alpha); bkg (n_rays, 3) f32 or null; group: lanes a ray, 32 or 8; tail
// (n_rays,) f32 or null (the tail mode, sigma modes only: each segment's last
// delta reaches the ray's tail z where it is finite); outputs rgb (n_rays, 3),
// depth/mask/trans_end (n_rays,) f32.
extern "C" int arcnerf_segment_march_fwd(const void* sigma, const void* rgb, const void* z, const void* off,
                                         const void* cnt, int n_rays, long long k_total, int mode,
                                         const void* bkg, int white_bkg, int group, const void* tail, void* out_rgb,
                                         void* out_depth, void* out_mask, void* out_trans_end, void* stream) {
    if (n_rays <= 0 || k_total < 0 || mode < 0 || mode > 2 || (mode == 2 && tail != nullptr))
        return ARCNERF_BAD_ARGUMENT;
    const auto* sp = static_cast<const float*>(sigma);
    const auto* cp = static_cast<const float*>(rgb);
    const auto* zp = static_cast<const float*>(z);
    const auto* op = static_cast<const int64_t*>(off);
    const auto* np = static_cast<const int64_t*>(cnt);
    const auto* bp = static_cast<const float*>(bkg);
    const auto* tp = static_cast<const float*>(tail);
    auto* orgb = static_cast<float*>(out_rgb);
    auto* od = static_cast<float*>(out_depth);
    auto* om = static_cast<float*>(out_mask);
    auto* ot = static_cast<float*>(out_trans_end);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (group) {
        case 32: launch<32>(sp, cp, zp, op, np, n_rays, k_total, mode, bp, white_bkg, tp, orgb, od, om, ot, s); break;
        case 8: launch<8>(sp, cp, zp, op, np, n_rays, k_total, mode, bp, white_bkg, tp, orgb, od, om, ot, s); break;
        default: return ARCNERF_BAD_ARGUMENT;
    }
    return static_cast<int>(cudaGetLastError());
}
