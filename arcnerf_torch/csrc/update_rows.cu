// Kernel J: lane-packed update rows,
//   out[k, l] = sum over i < n_off, f < F of [l == lane0[k] + offs[i] + f] * vals[k, i * F + f]
// for 128 lanes l, summed in (i, f) order from 0 as the plain version does.
//
// Replaces build_P / _pallas_kernel (scripts/probe_cons_forms.py), the
// single-pass Pallas construction of the (K, 128) one-hot update rows that
// the TPU's hash-table backward scattered into its lane-packed table.
//
// What bounds it on the H100: the bytes, K x 512 written beside K x (4 + 4
// n_terms) read (quad, K = 2^19: 256 MiB out, 18 MiB in). The first design
// (a warp a row) waited on each row's own loads; tiles of 32 rows a warp
// took that away but stayed ~20 % above the write alone, and a kernel that
// merely loads the inputs and stores zeros was no faster: interleaving the
// reads with the stream of writes costs HBM ~17-31 us at the probe's
// shapes, while the same reads alone take ~5 us
// (design_studies/update_rows_designs.py). So the kernel runs in two
// phases. A block an SM first copies its rows' lane0 and values into shared
// memory with two cp.async.bulk loads on an mbarrier, so the card reads
// every input in one burst before any row is written; then its 16 warps
// write the rows, a warp a row: each lane builds its 4 of the 128 floats
// from broadcast shared reads (no compare operand or partial sum reaches
// memory) and stores them as one evict-first float4, so the writes stream
// with no read between them. More rows than the card's shared memory holds
// go in further launches, each its own read burst. The number of terms is
// a template parameter (1..8), the term lanes offs[i] + f come by value.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kHead = 16;   // the mbarrier; the inputs follow
constexpr int kSlack = 64;  // the two input ranges widened to 16 bytes at both ends

struct Terms {
    int lane[8];  // term t = i * n_feat + f lands on lane0 + offs[i] + f
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load_start(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// bytes (a multiple of 16) from a 16-byte aligned global address into
// shared memory, counted on the mbarrier
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void load_wait(uint64_t* bar) {
    unsigned done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar))
            : "memory");
    } while (!done);
}

// Rows [r0, r0 + rows_per_block) of [row_begin, row_end) a block.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    build_update_rows_kernel(const int* __restrict__ lane0, const float* __restrict__ vals, int64_t row_begin,
                             int64_t row_end, int rows_per_block, Terms terms, float4* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t r0 = row_begin + static_cast<int64_t>(blockIdx.x) * rows_per_block;
    if (r0 >= row_end) return;
    const int rows = static_cast<int>(min(static_cast<int64_t>(rows_per_block), row_end - r0));
    // the block's lane0 and values, each range widened to 16-byte bounds
    // (cp.async.bulk's alignment; the widened bytes lie in the same 16-byte
    // granules as the range's ends)
    constexpr uintptr_t kAlign = 15;
    const uintptr_t a = reinterpret_cast<uintptr_t>(lane0 + r0), a_lo = a & ~kAlign,
                    a_hi = (a + static_cast<uintptr_t>(rows) * 4 + kAlign) & ~kAlign;
    const uintptr_t b = reinterpret_cast<uintptr_t>(vals + r0 * NT), b_lo = b & ~kAlign,
                    b_hi = (b + static_cast<uintptr_t>(rows) * NT * 4 + kAlign) & ~kAlign;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    unsigned char* slab_a = smem + kHead;
    unsigned char* slab_b = slab_a + (a_hi - a_lo);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1u) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        load_start(bar, static_cast<unsigned>((a_hi - a_lo) + (b_hi - b_lo)));
        bulk_load(slab_a, a_lo, static_cast<unsigned>(a_hi - a_lo), bar);
        bulk_load(slab_b, b_lo, static_cast<unsigned>(b_hi - b_lo), bar);
    }
    load_wait(bar);
    const int* s_lane0 = reinterpret_cast<const int*>(slab_a + (a - a_lo));
    const float* s_vals = reinterpret_cast<const float*>(slab_b + (b - b_lo));
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
        const int l0 = s_lane0[i];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int d = l0 + terms.lane[t] - 4 * lane;  // the term's place among this lane's 4 floats
            const float val = s_vals[i * NT + t];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d == c ? val : 0.f);
        }
        __stcs(out + (r0 + i) * 32 + lane, make_float4(acc[0], acc[1], acc[2], acc[3]));
    }
}

template <int NT>
int launch(const int* lane0, const float* vals, int64_t k, const Terms& terms, float4* out, cudaStream_t stream) {
    auto kernel = build_update_rows_kernel<NT>;
    // Per instantiation: the device last launched on, its SMs and the shared
    // memory a block may use there; the attribute is set when the device
    // changes, not at every launch.
    static int seen_device = -1, n_sm = 0, most_smem = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device != seen_device) {
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&most_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        }
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most_smem);
        }
        if (err != cudaSuccess) return static_cast<int>(err);
        seen_device = device;
    }
    // a round: as many rows as the SMs' shared memory holds, a block an SM
    const int64_t row_bytes = 4 + 4 * NT;
    const int64_t round_rows = (most_smem - kHead - kSlack) / row_bytes * n_sm;
    for (int64_t begin = 0; begin < k; begin += round_rows) {
        const int64_t n = k - begin < round_rows ? k - begin : round_rows;
        const int64_t per_block = (n + n_sm - 1) / n_sm;
        const int grid = static_cast<int>((n + per_block - 1) / per_block);
        const int smem = static_cast<int>(kHead + kSlack + per_block * row_bytes);
        kernel<<<grid, kThreads, smem, stream>>>(lane0, vals, begin, begin + n, static_cast<int>(per_block), terms,
                                                 out);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

// lane0 (k,) int32; vals (k, n_off * n_feat) f32, 4-byte aligned; offs
// (n_off,) host ints, n_off in 1..4 and n_off * n_feat <= 8; out (k, 128)
// f32, 16-byte aligned.
extern "C" int arcnerf_build_update_rows(const void* lane0, const void* vals, long long k, const int* offs,
                                         int n_off, int n_feat, void* out, void* stream) {
    if (k <= 0 || n_off < 1 || n_off > 4 || n_feat < 1 || n_off * n_feat > 8) return ARCNERF_BAD_ARGUMENT;
    Terms terms = {{0, 0, 0, 0, 0, 0, 0, 0}};
    for (int i = 0; i < n_off; ++i) {
        for (int f = 0; f < n_feat; ++f) terms.lane[i * n_feat + f] = offs[i] + f;
    }
    const int* l0 = static_cast<const int*>(lane0);
    const float* v = static_cast<const float*>(vals);
    float4* o = static_cast<float4*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_off * n_feat) {
        case 1: return launch<1>(l0, v, k, terms, o, s);
        case 2: return launch<2>(l0, v, k, terms, o, s);
        case 3: return launch<3>(l0, v, k, terms, o, s);
        case 4: return launch<4>(l0, v, k, terms, o, s);
        case 5: return launch<5>(l0, v, k, terms, o, s);
        case 6: return launch<6>(l0, v, k, terms, o, s);
        case 7: return launch<7>(l0, v, k, terms, o, s);
        default: return launch<8>(l0, v, k, terms, o, s);
    }
}
