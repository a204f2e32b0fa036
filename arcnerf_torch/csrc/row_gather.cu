// Kernel G: row gather, out[n, :] = table[idx[n], :].
//
// Replaces the row-gather probes of the TPU repo, each a Pallas kernel that
// gathers whole rows by an index vector:
// pallas_vmem_gather_attempt (tools/roofline_hashgrid.py), case_taa0,
// case_ref_vec, case_scalar_loop and case_onehot
// (scripts/probe_pallas_gather.py), case_a, case_c, case_e, case_f and
// loop_gather (scripts/probe_pallas_gather2.py). On the TPU the question was
// which form Mosaic lowers; on the card it is only how fast a random row
// read runs.
//
// What bounds it on the H100: random row reads. A (2^14, 128) bf16 table
// (4 MiB) sits in the 50 MB L2; a (2^19, 128) f32 table (256 MiB) does
// not, so its rows come from HBM. Design: one warp per output row; lane 0
// reads the index and a shuffle broadcasts it; the row moves as 16-byte
// loads and stores, so a 512-byte f32 row is one warp-wide access. The
// kernel moves bytes, so one kernel serves every element type whose row is
// a multiple of 16 bytes (a 256-byte bf16 row leaves half the warp idle).
// Indices must lie in [0, n_table): nothing checks them.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                                                         int64_t n_rows, int chunks, uint4* __restrict__ out) {
    const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= n_rows) return;  // whole warps leave together
    int r = 0;
    if (lane == 0) r = idx[row];
    r = __shfl_sync(0xffffffffu, r, 0);
    const uint4* src = table + static_cast<int64_t>(r) * chunks;
    uint4* dst = out + row * chunks;
    for (int c = lane; c < chunks; c += 32) dst[c] = __ldg(src + c);
}

}  // namespace

// table (n_table, row_bytes) of any element type, 16-byte aligned; idx
// (n_rows,) int32 in [0, n_table); out (n_rows, row_bytes), 16-byte aligned.
extern "C" int arcnerf_row_gather(const void* table, long long n_table, int row_bytes, const void* idx,
                                  long long n_rows, void* out, void* stream) {
    if (n_table <= 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) return ARCNERF_BAD_ARGUMENT;
    const int threads = 256;
    const int64_t blocks = (n_rows * 32 + threads - 1) / threads;
    row_gather_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), static_cast<const int*>(idx), n_rows, row_bytes / 16,
        static_cast<uint4*>(out));
    return static_cast<int>(cudaGetLastError());
}
