// The warp-aggregated vector atomics of the hash grid's table scatters:
// kernel E (hash_encode_bwd.cu) and kernel L (hash_dx.cu), whose design
// notes E's header gives.
#pragma once

#include "common.cuh"

namespace hash_scatter {

constexpr unsigned kFull = 0xffffffffu;

// Sums v over the lanes of the warp that pass the same key; returns true on
// the lowest lane of each group, which then holds its group's sum. Every
// lane of the warp calls it. Tree over the group's ranks: at step d the
// member of rank r (r a multiple of 2d) adds the partial sum of rank r + d.
template <int N>
__device__ __forceinline__ bool warp_group_sum(uint32_t key, float (&v)[N]) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned below = (1u << lane) - 1u;
    const unsigned group = __match_any_sync(kFull, key);
    const unsigned size = __popc(group);
    const unsigned widest = __reduce_max_sync(kFull, size);
    if (widest > 1) {
        const unsigned rank = __popc(group & below);
        unsigned next = group & ~(below | (1u << lane));  // the members above this lane
        for (unsigned d = 1; d < widest; d <<= 1) {
            for (unsigned i = 0; i < d / 2; ++i) next &= next - 1u;  // lowest bit: the member d ranks up
            const int src = next ? __ffs(next) - 1 : static_cast<int>(lane);
            const bool take = (rank & (2 * d - 1)) == 0 && rank + d < size;
#pragma unroll
            for (int f = 0; f < N; ++f) {
                const float t = __shfl_sync(kFull, v[f], src);
                if (take) v[f] += t;
            }
        }
    }
    return (group & below) == 0;
}

template <int N>
__device__ __forceinline__ bool any_nonzero(const float (&v)[N]) {
    bool nonzero = false;
#pragma unroll
    for (int f = 0; f < N; ++f) nonzero |= v[f] != 0.f;
    return nonzero;
}

// dst[0:N] += v with one vector atomic, two for N = 8. grad comes from
// torch.zeros, whose storage is aligned to at least 16 bytes, and a level
// holds T >= 2 entries of F floats, so a slot (N = 2F, F <= 2) and a row
// (N = F >= 4) start on a multiple of 4N bytes: the float2 and float4
// atomics rely on that.
template <int N>
__device__ __forceinline__ void add_vector(float* dst, const float (&v)[N]) {
    if constexpr (N == 2) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    } else {
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
            atomicAdd(reinterpret_cast<float4*>(dst) + q,
                      make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
}

// Adds t (F floats) into the half of the slot v (2F floats) that entry e
// takes: the low half for an even entry, the high half for an odd one.
template <int F>
__device__ __forceinline__ void add_half(uint32_t e, const float (&t)[F], float (&v)[2 * F]) {
    const bool odd = e & 1u;
#pragma unroll
    for (int f = 0; f < F; ++f) {
        v[f] += odd ? 0.f : t[f];
        v[F + f] += odd ? t[f] : 0.f;
    }
}

}  // namespace hash_scatter
