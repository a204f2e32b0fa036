// Warp-parallel scans over the samples of a ray's segment, for the
// compositing kernels (C, segment_march.cu, and F, segment_march_bwd.cu): a
// group of W lanes (W = 32, or 16 / 8 / 4 for several short rays a warp)
// takes W consecutive samples at a time, and each scan runs over the
// group's lanes with width-W shuffles, so the groups of a warp never mix.
// Both kernels load a chunk's samples with load_sample, so they read one
// definition of delta, alpha and o. In the alpha mode (Alpha = true: an
// SDF's sections) the stream's sigma holds each sample's alpha, and delta
// and the exponential play no part.
//
// Products and sums use the _rn intrinsics, so nvcc contracts nothing into
// an FMA and the order of every rounding is the one written here (the CPU
// model in tests/test_torch_march_numerics.py follows it).
#pragma once

#include "common.cuh"

namespace seg_scan {

// The lanes of the calling thread's group of W within its warp.
template <int W>
__device__ __forceinline__ unsigned group_mask() {
    if constexpr (W == 32) {
        return 0xffffffffu;
    } else {
        return ((1u << W) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(W - 1));
    }
}

// Inclusive product scan: lane i of the group gets v_0 * v_1 * ... * v_i,
// by log2(W) shuffle steps (step d multiplies in the partial product of
// the d lanes below).
template <int W>
__device__ __forceinline__ float product_scan(unsigned mask, int lane, float v) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const float t = __shfl_up_sync(mask, v, d, W);
        if (lane >= d) v = __fmul_rn(t, v);
    }
    return v;
}

// The sum of v over the group's lanes, by log2(W) butterfly steps: every
// lane gets the same value, lane 0's taken as ((v_0 + v_(W/2)) + (v_(W/4) +
// v_(3W/4))) + ... (step d adds the partial sum of the lane d away).
template <int W>
__device__ __forceinline__ float group_sum(unsigned mask, float v) {
#pragma unroll
    for (int d = W / 2; d >= 1; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(mask, v, d, W));
    return v;
}

// One sample of a chunk: lane `lane` of the group on stream row i (rows at
// or past `end` are outside the segment and come out as alpha 0, o 1). The
// delta to the next sample of the segment comes from the lane above by a
// shuffle, and from one load at the chunk's edge; deltas below 1e-5 are
// crushed to 0, the segment's last one is 1e10 under add_inf_z, else 0. With
// Tail (kernel C on a window of the windowed tier) the segment's last delta
// reaches the ray's tail z where it is finite, crushed as the others.
struct Sample {
    float z, s_raw, delta, ex, alpha, o;
};

// What a sample reads from the stream (its z, the next z at the chunk's
// edge, its sigma): issued apart from finish_sample, so that a kernel can
// load the next chunk while it works on this one.
struct Loaded {
    float z, z_edge, s_raw;
};

template <int W>
__device__ __forceinline__ Loaded load_row(const float* __restrict__ sigma, const float* __restrict__ z, int64_t i,
                                           int64_t end, int lane) {
    const bool in = i < end;
    return {in ? z[i] : 0.f, lane == W - 1 && i + 1 < end ? z[i + 1] : 0.f, in ? sigma[i] : 0.f};
}

template <int W, bool Alpha = false, bool Tail = false>
__device__ __forceinline__ Sample finish_sample(Loaded r, int64_t i, int64_t end, int add_inf_z, unsigned mask,
                                                int lane, float tail = 0.f) {
    Sample p;
    const bool in = i < end;
    p.z = r.z;
    if constexpr (Alpha) {
        p.s_raw = r.s_raw;
        p.delta = 0.f;
        p.ex = 1.f;
        p.alpha = in ? r.s_raw : 0.f;
        p.o = in ? __fadd_rn(__fsub_rn(1.f, p.alpha), 1e-10f) : 1.f;
        return p;
    }
    float z_next = __shfl_down_sync(mask, p.z, 1, W);
    if (lane == W - 1) z_next = r.z_edge;
    if (i + 1 < end) {
        const float d = __fsub_rn(z_next, p.z);
        p.delta = fabsf(d) < 1e-5f ? 0.f : d;
    } else if (Tail && tail < __int_as_float(0x7f800000)) {
        const float d = __fsub_rn(tail, p.z);
        p.delta = fabsf(d) < 1e-5f ? 0.f : d;
    } else {
        p.delta = add_inf_z ? 1e10f : 0.f;
    }
    p.s_raw = r.s_raw;
    const float s = fminf(fmaxf(p.s_raw, 0.f), 1e10f);
    p.ex = expf(__fmul_rn(-s, p.delta));
    p.alpha = in ? __fsub_rn(1.f, p.ex) : 0.f;
    p.o = in ? __fadd_rn(__fsub_rn(1.f, p.alpha), 1e-10f) : 1.f;
    return p;
}

template <int W, bool Alpha = false>
__device__ __forceinline__ Sample load_sample(const float* __restrict__ sigma, const float* __restrict__ z,
                                              int64_t i, int64_t end, int add_inf_z, unsigned mask, int lane) {
    return finish_sample<W, Alpha>(load_row<W>(sigma, z, i, end, lane), i, end, add_inf_z, mask, lane);
}

// An affine map R -> a + o R; compose(f, g) is f after g: R -> f(g(R)).
struct Affine {
    float a, o;
};

__device__ __forceinline__ Affine compose(Affine f, Affine g) {
    return {__fadd_rn(f.a, __fmul_rn(f.o, g.a)), __fmul_rn(f.o, g.o)};
}

__device__ __forceinline__ float apply(Affine f, float r) {
    return __fadd_rn(f.a, __fmul_rn(f.o, r));
}

// Inclusive reverse scan of affine maps: lane i of the group gets
// f_i o f_(i+1) o ... o f_(W-1), by log2(W) shuffle steps (step d composes
// with the partial map of the d lanes above). Lanes past a segment's end
// carry the identity (a = 0, o = 1).
template <int W>
__device__ __forceinline__ Affine suffix_scan(unsigned mask, int lane, Affine f) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const Affine g = {__shfl_down_sync(mask, f.a, d, W), __shfl_down_sync(mask, f.o, d, W)};
        if (lane + d < W) f = compose(f, g);
    }
    return f;
}

}  // namespace seg_scan
