// Kernel I: row scatter-add in place, out[idx[n], :] += g[n, :] for every
// n, with repeated indices summed.
//
// Replaces case_scatter_ref (scripts/probe_pallas_gather.py), the Pallas
// kernel that scatter-adds rows by an index vector (`o_ref[idx] += g`). It
// computes what that probe compares with, np.add.at: in Pallas interpret
// mode the kernel keeps one update per repeated index instead. It also
// serves the XLA scatter-adds the probes time beside it (probe_scatter.py's
// cases a, d and f, probe_cons_forms.py's scatter tail).
//
// What bounds it on the H100: atomic throughput in L2, and collisions on
// repeated indices (kernel E's scale, 2^25 updates into 2^23 entries, has
// four updates per entry; a (16384, 128) table under 2^20 rows has 64 per
// row). Design: W a multiple of 4 - one thread per (row, 4-float chunk),
// one 16-byte vector atomicAdd on float4 (Hopper's global-memory vector
// atomic), so a warp covers a 512-byte row in one instruction; W = 1 - one
// scalar atomicAdd per update. Neither reads the table back, so the
// compiler emits reductions (RED), not atomics that return. Sums land in
// an order that changes from run to run. Indices must lie in [0, n_table):
// nothing checks them.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) scatter_add_rows_vec4_kernel(float4* __restrict__ out,
                                                                    const int* __restrict__ idx,
                                                                    const float4* __restrict__ g, int64_t n,
                                                                    int64_t chunks) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n * chunks) return;
    const int64_t row = t / chunks;
    const int64_t c = t - row * chunks;
    atomicAdd(out + static_cast<int64_t>(idx[row]) * chunks + c, g[t]);
}

__global__ void __launch_bounds__(256) scatter_add_scalar_kernel(float* __restrict__ out, const int* __restrict__ idx,
                                                                 const float* __restrict__ g, int64_t n) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n) return;
    atomicAdd(out + idx[t], g[t]);
}

}  // namespace

// out (n_table, w) f32, 16-byte aligned when w > 1, accumulated into; idx
// (n,) int32 in [0, n_table); g (n, w) f32. w is 1 or a multiple of 4.
extern "C" int arcnerf_scatter_add_rows(void* out, long long n_table, int w, const void* idx, const void* g,
                                        long long n, void* stream) {
    if (n_table <= 0 || n <= 0 || w <= 0 || (w != 1 && w % 4 != 0)) return ARCNERF_BAD_ARGUMENT;
    const int threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    if (w == 1) {
        const int64_t blocks = (n + threads - 1) / threads;
        scatter_add_scalar_kernel<<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
            static_cast<float*>(out), ip, static_cast<const float*>(g), n);
    } else {
        const int64_t chunks = w / 4;
        const int64_t blocks = (n * chunks + threads - 1) / threads;
        scatter_add_rows_vec4_kernel<<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
            static_cast<float4*>(out), ip, static_cast<const float4*>(g), n, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}
