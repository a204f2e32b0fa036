// Kernel J: lane-packed update rows,
//   out[k, l] = sum over i < n_off, f < F of [l == lane0[k] + offs[i] + f] * vals[k, i * F + f]
// for 128 lanes l, summed in (i, f) order from 0 as the plain version does.
//
// Replaces build_P / _pallas_kernel (scripts/probe_cons_forms.py), the
// single-pass Pallas construction of the (K, 128) one-hot update rows that
// the TPU's hash-table backward scattered into its lane-packed table.
//
// What bounds it on the H100: the write, K x 512 bytes per level; the
// reads (4 + 4 * n_off * F bytes per row) are small beside it. Design: one
// warp per row; each lane owns 4 of the 128 floats and compares its lane
// numbers with each term's lane, so no (K, 128) compare operand or partial
// sum ever reaches memory, and the row is written once as one coalesced
// 512-byte float4 store. The offsets (at most 4) come by value.

#include "common.cuh"

namespace {

struct Offsets {
    int v[4];
};

__global__ void __launch_bounds__(256) build_update_rows_kernel(const int* __restrict__ lane0,
                                                                const float* __restrict__ vals, int64_t k_rows,
                                                                Offsets offs, int n_off, int n_feat,
                                                                float4* __restrict__ out) {
    const int64_t k = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (k >= k_rows) return;
    const int l0 = lane0[k];
    const float* v = vals + k * (n_off * n_feat);
    const int first = 4 * lane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n_off; ++i) {
        for (int f = 0; f < n_feat; ++f) {
            const int target = l0 + offs.v[i] + f;
            const float val = v[i * n_feat + f];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], first + c == target ? val : 0.f);
        }
    }
    out[k * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

}  // namespace

// lane0 (k,) int32; vals (k, n_off * n_feat) f32; offs (n_off,) host ints,
// n_off in 1..4 and n_off * n_feat <= 8; out (k, 128) f32, 16-byte aligned.
extern "C" int arcnerf_build_update_rows(const void* lane0, const void* vals, long long k, const int* offs,
                                         int n_off, int n_feat, void* out, void* stream) {
    if (k <= 0 || n_off < 1 || n_off > 4 || n_feat < 1 || n_off * n_feat > 8) return ARCNERF_BAD_ARGUMENT;
    Offsets o = {{0, 0, 0, 0}};
    for (int i = 0; i < n_off; ++i) o.v[i] = offs[i];
    const int threads = 256;
    const int64_t blocks = (k * 32 + threads - 1) / threads;
    build_update_rows_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lane0), static_cast<const float*>(vals), k, o, n_off, n_feat,
        static_cast<float4*>(out));
    return static_cast<int>(cudaGetLastError());
}
