// Warp-parallel scans over the samples of a ray's segment, for the
// compositing kernels (F, segment_march_bwd.cu; C can take them up): a
// group of W lanes (W = 32, or 16 / 8 for several short rays a warp) takes
// W consecutive samples at a time, and each scan runs over the group's
// lanes with width-W shuffles, so the groups of a warp never mix.
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
