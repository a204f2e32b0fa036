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
// not, so most of its rows come from HBM, about four times each under 2^21
// uniform indices. Design:
// - a row moves as 16-byte loads and stores, a group of L lanes a row (L the
//   row's 16-byte chunks rounded up to a power of two, at most 32): a
//   512-byte f32 row is one warp-wide access, a 256-byte bf16 row a
//   half-warp's, so no lane idles; longer rows loop;
// - each group issues the loads of kRows rows before their stores, so a
//   warp keeps kRows x 512 bytes in flight; one pass, a group per kRows
//   rows (a grid-stride walk over a resident-sized grid measured slower);
// - the output goes out with streaming stores (st.global.cs), so it does
//   not push the table's rows out of L2 (plain stores measured slower).
// On a (2^19, 128) f32 table under 2^21 indices the card moves ~1.9 GB
// (each row read from HBM about four times, the L2 holding a fifth of the
// table, and 1.07 GB out) where the bound counts each distinct row once
// (0.27 GB in).
// The kernel moves bytes, so one kernel serves every element type whose row
// is a multiple of 16 bytes, and the output is the table's bits.
// Indices must lie in [0, n_table): nothing checks them.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a group has in flight

template <int L>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(const uint4* __restrict__ table,
                                                              const int* __restrict__ idx, int64_t n_rows, int chunks,
                                                              uint4* __restrict__ out) {
    constexpr int kGroups = kThreads / L;  // row groups a block
    const int lane = threadIdx.x % L;
    const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / L) * kRows;
    if (row0 >= n_rows) return;
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
        for (int i = 0; i < kRows; ++i)
            if (row0 + i < n_rows) __stcs(out + (row0 + i) * chunks + c, v[i]);
    }
}

template <int L>
int launch(const void* table, const void* idx, int64_t n_rows, int chunks, void* out, cudaStream_t stream) {
    constexpr int64_t kRowsPerBlock = static_cast<int64_t>(kThreads / L) * kRows;
    const int64_t blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > INT_MAX) return ARCNERF_BAD_ARGUMENT;
    row_gather_kernel<L><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint4*>(table), static_cast<const int*>(idx), n_rows, chunks, static_cast<uint4*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (n_table, row_bytes) of any element type, 16-byte aligned; idx
// (n_rows,) int32 in [0, n_table); out (n_rows, row_bytes), 16-byte aligned.
extern "C" int arcnerf_row_gather(const void* table, long long n_table, int row_bytes, const void* idx,
                                  long long n_rows, void* out, void* stream) {
    if (n_table <= 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) return ARCNERF_BAD_ARGUMENT;
    const int chunks = row_bytes / 16;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (chunks <= 1) return launch<1>(table, idx, n_rows, chunks, out, s);
    if (chunks <= 2) return launch<2>(table, idx, n_rows, chunks, out, s);
    if (chunks <= 4) return launch<4>(table, idx, n_rows, chunks, out, s);
    if (chunks <= 8) return launch<8>(table, idx, n_rows, chunks, out, s);
    if (chunks <= 16) return launch<16>(table, idx, n_rows, chunks, out, s);
    return launch<32>(table, idx, n_rows, chunks, out, s);
}
