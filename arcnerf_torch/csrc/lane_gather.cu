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
// L2 sector: an (8, 2^19) gather reads 4 Mi sectors (128 MiB of L2 traffic)
// for 16 MiB of values. The (8, 2^19) f32 source (16 MiB) fits the 50 MB L2,
// so the reads hit L2 and the index read and output write stream; the rate
// at which L2 serves random sectors sets the time, not HBM.
// Design: one thread an output, the column from blockIdx.x and threadIdx.x
// and the row from blockIdx.y (rows past gridDim.y loop), so no thread
// divides its position into a row and a column; index reads and output
// writes coalesce. Designs that give a thread 4 or 8 outputs (16-byte index
// loads and stores, a shared index row kept in registers for 8 rows)
// measured slower at every probe shape (design_studies/gather_designs.py);
// why was not measured. On the H100 the device time matches the earlier
// one-thread-an-output kernel's within noise; one random 4-byte read an
// output, with no index read at all, takes 87 % of it.
// Indices must lie in [0, w_src): nothing checks them.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) lane_gather_kernel(const float* __restrict__ src, int64_t w_src,
                                                               const int* __restrict__ idx, int64_t idx_stride,
                                                               int64_t m, int64_t n, float* __restrict__ out) {
    const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (j >= n) return;
    for (int64_t r = blockIdx.y; r < m; r += gridDim.y)
        out[r * n + j] = __ldg(src + r * w_src + idx[r * idx_stride + j]);
}

}  // namespace

// src (m, w_src) f32; idx int32 with rows of n, row stride idx_stride (n, or
// 0 for one row shared by all m rows); out (m, n) f32.
extern "C" int arcnerf_lane_gather(const void* src, long long m, long long w_src, const void* idx,
                                   long long idx_stride, long long n, void* out, void* stream) {
    if (m <= 0 || w_src <= 0 || n <= 0 || (idx_stride != 0 && idx_stride != n)) return ARCNERF_BAD_ARGUMENT;
    const int64_t blocks_x = (n + kThreads - 1) / kThreads;
    if (blocks_x > INT_MAX) return ARCNERF_BAD_ARGUMENT;
    const dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(m < kMaxGridY ? m : kMaxGridY));
    lane_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), w_src, static_cast<const int*>(idx), idx_stride, m, n,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
