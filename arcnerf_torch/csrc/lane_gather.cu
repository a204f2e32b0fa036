// Kernel H: lane gather, out[m, j] = src[m, idx[m or 0, j]] - numpy's
// take_along_axis on the last axis, with an index row shared by every row
// when its row stride is 0.
//
// Replaces the lane-gather probes of the TPU repo: case_lane_gather and
// lane_gather (scripts/probe_scatter.py), case_take_1d and case_taa1
// (scripts/probe_pallas_gather.py), case_b and case_d
// (scripts/probe_pallas_gather2.py).
//
// What bounds it on the H100: 4-byte random reads, each costing a 32-byte
// sector; an (8, 2^19) f32 source (16 MiB) fits the 50 MB L2, so the reads
// are L2 hits and the index read and output write stream. Design: one
// thread per output element, row-major, so index reads and output writes
// coalesce. Indices must lie in [0, w_src): nothing checks them.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) lane_gather_kernel(const float* __restrict__ src, int64_t w_src,
                                                          const int* __restrict__ idx, int64_t idx_stride,
                                                          int64_t n, int64_t total, float* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int64_t m = t / n;
    const int64_t j = t - m * n;
    out[t] = src[m * w_src + idx[m * idx_stride + j]];
}

}  // namespace

// src (m, w_src) f32; idx int32 with rows of n, row stride idx_stride (n, or
// 0 for one row shared by all m rows); out (m, n) f32.
extern "C" int arcnerf_lane_gather(const void* src, long long m, long long w_src, const void* idx,
                                   long long idx_stride, long long n, void* out, void* stream) {
    if (m <= 0 || w_src <= 0 || n <= 0 || (idx_stride != 0 && idx_stride != n)) return ARCNERF_BAD_ARGUMENT;
    const int threads = 256;
    const int64_t total = m * n;
    const int64_t blocks = (total + threads - 1) / threads;
    lane_gather_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), w_src, static_cast<const int*>(idx), idx_stride, n, total,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
