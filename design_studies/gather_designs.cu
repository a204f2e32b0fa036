// Design variants of kernels G (row gather) and H (lane gather), for
// design_studies/gather_designs.py: the designs the kernels in
// arcnerf_torch/csrc/ were chosen against, and a floor probe for H. Not
// part of the port's kernels: nothing in the package launches these.
//
// G variants, out[n, :] = table[idx[n], :] (rows of 256 or 512 bytes):
//   0 plain stores        the kernel's design with st.global instead of st.global.cs
//   1 grid-stride         the same groups walking the rows over a grid of the resident blocks
//   2 warp a row          the earlier kernel: a warp a row, lane 0 reads the index
// H variants, out[m, j] = src[m, idx[m or 0, j]]:
//   0 four a thread       16-byte index loads and stores, a shared index row
//                         kept in registers for 8 rows, all loads before the stores
//   1 eight a thread      the same with two 16-byte index loads a thread
//   2 divide              the earlier kernel: one thread an output, the row by a 64-bit divide
//   3 floor               one random 4-byte read an output at a hashed address,
//                         no index: the rate L2 serves random sectors

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;

template <int L, bool kStreaming, bool kGridStride>
__global__ void __launch_bounds__(kThreads) row_gather_variant(const uint4* __restrict__ table,
                                                               const int* __restrict__ idx, int64_t n_rows,
                                                               int chunks, uint4* __restrict__ out) {
    constexpr int kGroups = kThreads / L;
    const int lane = threadIdx.x % L;
    const int64_t stride = kGridStride ? static_cast<int64_t>(gridDim.x) * kGroups * kRows : n_rows;
    for (int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / L) * kRows; row0 < n_rows;
         row0 += stride) {
        const uint4* src[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            src[i] = table + static_cast<int64_t>(row0 + i < n_rows ? __ldg(idx + row0 + i) : 0) * chunks;
        for (int c = lane; c < chunks; c += L) {
            uint4 v[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                if (row0 + i < n_rows) v[i] = __ldg(src[i] + c);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                if (row0 + i >= n_rows) continue;
                if (kStreaming) {
                    __stcs(out + (row0 + i) * chunks + c, v[i]);
                } else {
                    out[(row0 + i) * chunks + c] = v[i];
                }
            }
        }
    }
}

__global__ void __launch_bounds__(256) row_gather_warp(const uint4* __restrict__ table, const int* __restrict__ idx,
                                                       int64_t n_rows, int chunks, uint4* __restrict__ out) {
    const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= n_rows) return;
    int r = 0;
    if (lane == 0) r = idx[row];
    r = __shfl_sync(0xffffffffu, r, 0);
    for (int c = lane; c < chunks; c += 32) out[row * chunks + c] = __ldg(table + static_cast<int64_t>(r) * chunks + c);
}

template <int L>
int launch_rows(int variant, const uint4* table, const int* idx, int64_t n_rows, int chunks, uint4* out,
                cudaStream_t s) {
    constexpr int64_t kPerBlock = static_cast<int64_t>(kThreads / L) * kRows;
    int64_t blocks = (n_rows + kPerBlock - 1) / kPerBlock;
    if (variant == 0) {
        row_gather_variant<L, false, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(table, idx, n_rows,
                                                                                              chunks, out);
    } else if (variant == 1) {
        int device = 0, n_sm = 0, per_sm = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_variant<L, true, true>, kThreads, 0);
        if (blocks > static_cast<int64_t>(n_sm) * per_sm) blocks = static_cast<int64_t>(n_sm) * per_sm;
        row_gather_variant<L, true, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(table, idx, n_rows,
                                                                                            chunks, out);
    } else {
        row_gather_warp<<<static_cast<unsigned>((n_rows * 32 + 255) / 256), 256, 0, s>>>(table, idx, n_rows, chunks,
                                                                                        out);
    }
    return static_cast<int>(cudaGetLastError());
}

template <int kPer, int kRowsShared>
__global__ void __launch_bounds__(kThreads) lane_gather_variant(const float* __restrict__ src, int64_t w_src,
                                                                const int* __restrict__ idx, int64_t idx_stride,
                                                                int64_t m, int64_t n, float* __restrict__ out) {
    const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
    if (j0 >= n) return;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRowsShared; r0 < m;
         r0 += static_cast<int64_t>(gridDim.y) * kRowsShared) {
        int k[kPer];
#pragma unroll
        for (int q = 0; q < kPer; q += 4) {
            const int4 v = *reinterpret_cast<const int4*>(idx + r0 * idx_stride + j0 + q);
            k[q] = v.x, k[q + 1] = v.y, k[q + 2] = v.z, k[q + 3] = v.w;
        }
        float v[kRowsShared][kPer];
#pragma unroll
        for (int i = 0; i < kRowsShared; ++i)
            if (r0 + i < m)
#pragma unroll
                for (int q = 0; q < kPer; ++q) v[i][q] = __ldg(src + (r0 + i) * w_src + k[q]);
#pragma unroll
        for (int i = 0; i < kRowsShared; ++i)
            if (r0 + i < m)
#pragma unroll
                for (int q = 0; q < kPer; q += 4)
                    *reinterpret_cast<float4*>(out + (r0 + i) * n + j0 + q) =
                        make_float4(v[i][q], v[i][q + 1], v[i][q + 2], v[i][q + 3]);
    }
}

__global__ void lane_gather_divide(const float* __restrict__ src, int64_t w_src, const int* __restrict__ idx,
                                   int64_t idx_stride, int64_t n, int64_t total, float* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int64_t m = t / n;
    const int64_t j = t - m * n;
    out[t] = src[m * w_src + idx[m * idx_stride + j]];
}

__global__ void random_read_floor(const float* __restrict__ src, uint32_t mask, int64_t total,
                                  float* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    uint32_t h = static_cast<uint32_t>(t) * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    out[t] = __ldg(src + (h & mask));
}

template <int kPer>
void launch_lanes(const float* src, int64_t m, int64_t w_src, const int* idx, int64_t idx_stride, int64_t n,
                  float* out, cudaStream_t s) {
    const int64_t blocks_x = ((n + kPer - 1) / kPer + kThreads - 1) / kThreads;
    if (idx_stride == 0) {
        const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>((m + 7) / 8));
        lane_gather_variant<kPer, 8><<<grid, kThreads, 0, s>>>(src, w_src, idx, 0, m, n, out);
    } else {
        const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(m));
        lane_gather_variant<kPer, 1><<<grid, kThreads, 0, s>>>(src, w_src, idx, idx_stride, m, n, out);
    }
}

}  // namespace

// table (n_table, row_bytes), row_bytes 256 or 512; as arcnerf_row_gather.
extern "C" int design_row_gather(int variant, const void* table, int row_bytes, const void* idx, long long n_rows,
                                 void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int chunks = row_bytes / 16;
    const auto* t = static_cast<const uint4*>(table);
    const auto* i = static_cast<const int*>(idx);
    auto* o = static_cast<uint4*>(out);
    if (chunks == 16) return launch_rows<16>(variant, t, i, n_rows, chunks, o, s);
    if (chunks == 32) return launch_rows<32>(variant, t, i, n_rows, chunks, o, s);
    return -1;
}

// src (m, w_src) f32, idx rows of n (n a multiple of 8, 16-byte aligned)
// with row stride idx_stride (n or 0); variant 3 needs m * w_src a power of two.
extern "C" int design_lane_gather(int variant, const void* src, long long m, long long w_src, const void* idx,
                                  long long idx_stride, long long n, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* f = static_cast<const float*>(src);
    const auto* i = static_cast<const int*>(idx);
    auto* o = static_cast<float*>(out);
    const int64_t total = m * n;
    if (variant == 0) launch_lanes<4>(f, m, w_src, i, idx_stride, n, o, s);
    if (variant == 1) launch_lanes<8>(f, m, w_src, i, idx_stride, n, o, s);
    if (variant == 2)
        lane_gather_divide<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(f, w_src, i, idx_stride, n,
                                                                                      total, o);
    if (variant == 3)
        random_read_floor<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
            f, static_cast<uint32_t>(m * w_src - 1), total, o);
    return static_cast<int>(cudaGetLastError());
}
