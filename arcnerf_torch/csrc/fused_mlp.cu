// Kernel A: fused bias-free MLP forward on the H100's bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulation).
//
// Replaces the Pallas forward of arcnerf_tpu/ops/fused_mlp.py
// (_run_forward / _fwd_kernel). Semantics: the input is rounded to bf16,
// every layer accumulates exact bf16 x bf16 products in f32, ReLU runs in
// f32 on every layer but the last, and every layer's output is rounded to
// bf16; the result is written as f32. With save_pre (the differentiated
// forward, _fused_mlp_fwd) each hidden layer's pre-activation z is also
// written, rounded to bf16 before the ReLU, for kernel D.
//
// What bounds it on the H100: at 2^18 rows it moves x and out once, and with
// save_pre the bf16 pre-activations: geo (32->64->16) 192 B a row, 320 B
// with save_pre; radiance (18->64->64->3) 84 B, 340 B with save_pre. That is
// 70.8 MB (0.021 ms at 3.35 TB/s) for the inference build and 171.4 MB
// (0.051 ms) with save_pre. The padded chains' 1.6 + 3.5 GFLOP take ~5 us
// at the bf16 tensor-core peak, so A is bound by bytes, 4-10x over. The
// design feeds the tensor cores from registers and spends its care on the
// bytes: each row is read once and written once, in whole lines. wgmma is
// not used: Hopper's asynchronous warpgroup MMA would only speed up those
// ~5 us of compute.
//
// Design. Persistent blocks of 4 warps (4 an SM) stage the chain's weights
// in shared memory once, as bf16 rows of 72 (144 B, so ldmatrix.trans reads
// the B fragments without bank conflicts; the (64, 4) output block padded
// to 8 columns). Each warp then walks its own 32-row tiles, two m16 tiles,
// so that every B fragment feeds two MMAs:
// - x: a tile's rows are one contiguous run of 32 d_in floats, copied by
//   cp.async into a warp buffer one tile ahead. The run starts 16-byte
//   aligned whatever d_in is, so 16-byte copies (4-byte ones when x itself is
//   not 16-byte aligned); no row is copied on its own, since radiance rows
//   are 72 bytes, 8-byte aligned only. The A fragments take columns
//   d_in..DIN-1 and rows past n_rows as zero and never read them.
// - The hidden activations never leave registers: the accumulators of
//   n-tiles 2j and 2j+1 (rows g and g+8, columns 2t and 2t+1 of each) are,
//   after ReLU and bf16 packing, the A fragment of k-step j of the next
//   layer.
// - pre: a layer's 32 x 64 bf16 go through the warp's x buffer (16-byte
//   chunks XOR-swizzled by row: conflict-free both ways) and out in 16-byte
//   stores, 512 contiguous bytes a warp instruction (a tile's rows of one
//   layer are contiguous in pre).
// - out: f32 from the output layer's fragments, masked to d_out.
// The inference and save_pre builds share this code; save_pre only adds the
// pre stores, so their outputs are bit-equal, and with no atomics two calls
// agree bit for bit. The summation order is the MMA's (16 products a step
// into the f32 accumulator), not the plain version's, so a bf16 rounding
// flips now and then (tests/test_torch_mlp_fwd_numerics.py).

#include "mma.cuh"

namespace {

constexpr int kW = 64;           // chain width
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 4;
constexpr int kM = 2;            // m16 tiles in a warp tile
constexpr int kRows = 16 * kM;   // rows of a warp tile
constexpr int kStride = kW + 8;  // bf16 a shared-memory weight row: 144 B, conflict-free ldmatrix

// acc = a W for the warp tile: K inputs, NT n-tiles of 8 columns; w is the
// layer's weights in shared memory, row k at w + k kStride.
template <int K, int NT>
__device__ __forceinline__ void layer(const uint32_t (&a)[kM][K / 16][4], const __nv_bfloat16* w,
                                      float (&acc)[kM][NT][4], int lane) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    const int q = lane >> 3, r = lane & 7;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
        if constexpr (NT == 1) {
            // B fragment: the 8x8 blocks at rows 16 kk and 16 kk + 8
            uint32_t b[2];
            ldsm_x2_trans(b, w + (16 * kk + (lane & 15)) * kStride);
#pragma unroll
            for (int m = 0; m < kM; ++m) mma_bf16(acc[m][0], a[m][kk], b[0], b[1]);
        } else {
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                // B fragments of n-tiles j and j + 1: rows 16 kk + {0, 8}, columns 8 j + {0, 8}
                uint32_t b[4];
                ldsm_x4_trans(b, w + (16 * kk + r + (q & 1) * 8) * kStride + 8 * j + (q >> 1) * 8);
#pragma unroll
                for (int m = 0; m < kM; ++m) {
                    mma_bf16(acc[m][j], a[m][kk], b[0], b[1]);
                    mma_bf16(acc[m][j + 1], a[m][kk], b[2], b[3]);
                }
            }
        }
    }
}

// The next layer's A fragments from a 64-wide layer's accumulators:
// bf16(relu(z)), k-step kk from n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void to_a(const float (&acc)[kM][8][4], uint32_t (&a)[kM][4][4]) {
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int j = 2 * kk + (i >> 1), e = 2 * (i & 1);
                a[m][kk][i] = pack_bf16(fmaxf(acc[m][j][e], 0.f), fmaxf(acc[m][j][e + 1], 0.f));
            }
}

// The first layer's A fragments, bf16(x), from the warp tile's run of x in
// shared memory (row r at xs + r d_in); zero past d_in and past n_valid rows.
template <int DIN>
__device__ __forceinline__ void x_frags(const float* xs, int n_valid, int d_in, uint32_t (&a)[kM][DIN / 16][4],
                                        int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int kk = 0; kk < DIN / 16; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = 16 * m + g + 8 * (i & 1), c = 16 * kk + 2 * t + 8 * (i >> 1);
                const bool row_ok = r < n_valid;
                const float v0 = (row_ok && c < d_in) ? xs[r * d_in + c] : 0.f;
                const float v1 = (row_ok && c + 1 < d_in) ? xs[r * d_in + c + 1] : 0.f;
                a[m][kk][i] = pack_bf16(v0, v1);
            }
}

// Start copying the rows of warp tile `tile` into dst: one run of n_valid
// d_in floats.
__device__ __forceinline__ void load_x(const float* __restrict__ x, int tile, int n_rows, int d_in, bool aligned16,
                                       float* dst, int lane) {
    const int64_t row0 = static_cast<int64_t>(tile) * kRows;
    const int64_t left = n_rows - row0;
    const int n = (left < kRows ? static_cast<int>(left) : kRows) * d_in;
    const float* src = x + row0 * d_in;
    int e4 = 0;
    if (aligned16) {
        e4 = n & ~3;
        for (int e = 4 * lane; e < e4; e += 128) cp_async16(dst + e, src + e);
    }
    for (int e = e4 + lane; e < n; e += 32) cp_async4(dst + e, src + e);
}

// One hidden layer's pre-activations of the warp tile -> dst (the tile's
// first row of that layer in pre; n_valid rows): bf16 pairs into the staging
// buffer sp (row r's 16-byte chunk c at chunk c ^ (r & 7)), then whole rows
// out in 16-byte stores.
__device__ __forceinline__ void store_pre(const float (&acc)[kM][8][4], __nv_bfloat16* sp,
                                          __nv_bfloat16* __restrict__ dst, int n_valid, int lane) {
    const int g = lane >> 2, t = lane & 3;
    __syncwarp();  // every lane is done reading sp
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 16 * m + g + 8 * h;  // r & 7 == g
                *reinterpret_cast<uint32_t*>(sp + r * kW + ((j ^ g) << 3) + 2 * t) =
                        pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
            }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows * kW / 8 / 32; ++i) {
        const int e = lane + 32 * i, r = e >> 3, c = e & 7;
        if (r < n_valid)
            *reinterpret_cast<uint4*>(dst + r * kW + 8 * c) =
                    *reinterpret_cast<const uint4*>(sp + r * kW + ((c ^ (r & 7)) << 3));
    }
}

// The output layer's fragments -> out rows row0.. (n_valid of them), the
// bf16-rounded values as f32, columns past d_out dropped.
template <int NT>
__device__ __forceinline__ void store_out(const float (&acc)[kM][NT][4], float* __restrict__ out, int64_t row0,
                                          int n_valid, int d_out, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 16 * m + g + 8 * h, c = 8 * j + 2 * t;
                if (r >= n_valid) continue;
                float* dst = out + (row0 + r) * d_out + c;
                if (c < d_out) dst[0] = round_bf16(acc[m][j][2 * h]);
                if (c + 1 < d_out) dst[1] = round_bf16(acc[m][j][2 * h + 1]);
            }
}

// Stage the packed weights (W_0 and the hidden blocks 64 wide, W_out
// dout_pad wide) into ws, rows of kStride; W_out padded to NOUT columns.
// The 64-wide rows go by cp.async (the caller waits).
template <int DIN, int NOUT>
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* __restrict__ weights, int n_hidden, int dout_pad,
                                              __nv_bfloat16* ws) {
    const int rows64 = DIN + (n_hidden - 1) * kW;
    for (int e = threadIdx.x; e < rows64 * kW / 8; e += kThreads)
        cp_async16(ws + (e >> 3) * kStride + 8 * (e & 7), weights + 8 * e);
    const __nv_bfloat16* wo = weights + rows64 * kW;
    __nv_bfloat16* so = ws + rows64 * kStride;
    for (int e = threadIdx.x; e < kW * NOUT; e += kThreads) {
        const int k = e / NOUT, j = e % NOUT;
        so[k * kStride + j] = j < dout_pad ? wo[k * dout_pad + j] : __float2bfloat16_rn(0.f);
    }
}

template <int DIN, int DOUT, bool SAVE_PRE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) fused_mlp_fwd_kernel(
        const float* __restrict__ x, int n_rows, int d_in, bool x_aligned16, const __nv_bfloat16* __restrict__ weights,
        int n_hidden, int d_out, float* __restrict__ out, __nv_bfloat16* __restrict__ pre) {
    constexpr int NOUT = DOUT < 8 ? 8 : DOUT;  // the output layer's columns in shared memory
    // weights (DIN + 64 n_hidden rows of kStride bf16), then two x buffers
    // of kRows DIN floats a warp (the current one also stages pre)
    extern __shared__ uint4 smem4[];
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem4);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* cur = reinterpret_cast<float*>(ws + (DIN + n_hidden * kW) * kStride) + 2 * warp * kRows * DIN;
    float* nxt = cur + kRows * DIN;
    const int n_tiles = (n_rows + kRows - 1) / kRows;
    const int step = gridDim.x * kWarps;
    int tile = blockIdx.x * kWarps + warp;

    stage_weights<DIN, NOUT>(weights, n_hidden, DOUT, ws);
    if (tile < n_tiles) load_x(x, tile, n_rows, d_in, x_aligned16, cur, lane);
    cp_async_commit();
    cp_async_wait_group<0>();
    __syncthreads();

    for (; tile < n_tiles; tile += step) {
        __syncwarp();  // every lane is done with nxt (the last tile's staging)
        if (tile + step < n_tiles) load_x(x, tile + step, n_rows, d_in, x_aligned16, nxt, lane);
        cp_async_commit();
        cp_async_wait_group<1>();  // this tile's x
        __syncwarp();
        const int64_t row0 = static_cast<int64_t>(tile) * kRows;
        const int n_valid = n_rows - row0 < kRows ? static_cast<int>(n_rows - row0) : kRows;

        uint32_t a[kM][4][4];
        float acc[kM][8][4];
        {
            uint32_t a0[kM][DIN / 16][4];
            x_frags<DIN>(cur, n_valid, d_in, a0, lane);
            layer<DIN, 8>(a0, ws, acc, lane);
        }
        if constexpr (SAVE_PRE) store_pre(acc, reinterpret_cast<__nv_bfloat16*>(cur), pre + row0 * kW, n_valid, lane);
        to_a(acc, a);
        const __nv_bfloat16* wl = ws + DIN * kStride;
        for (int l = 1; l < n_hidden; ++l, wl += kW * kStride) {
            layer<kW, 8>(a, wl, acc, lane);
            if constexpr (SAVE_PRE)
                store_pre(acc, reinterpret_cast<__nv_bfloat16*>(cur),
                          pre + (static_cast<int64_t>(l) * n_rows + row0) * kW, n_valid, lane);
            to_a(acc, a);
        }
        float o[kM][NOUT / 8][4];
        layer<kW, NOUT / 8>(a, wl, o, lane);
        store_out<NOUT / 8>(o, out, row0, n_valid, d_out, lane);

        float* done = cur;
        cur = nxt;
        nxt = done;
    }
}

template <int DIN, int DOUT, bool SAVE_PRE>
int launch(const float* x, int n_rows, int d_in, const __nv_bfloat16* weights, int n_hidden, int d_out,
           float* out, __nv_bfloat16* pre, cudaStream_t stream) {
    auto kernel = fused_mlp_fwd_kernel<DIN, DOUT, SAVE_PRE>;
    const int smem = static_cast<int>(sizeof(__nv_bfloat16) * (DIN + n_hidden * kW) * kStride +
                                      sizeof(float) * kWarps * 2 * kRows * DIN);
    // Per instantiation: the device last launched on, the shared memory the
    // attribute allows there, and the grid for the last size; the attribute
    // and the occupancy query run when these change, not at every launch.
    static int seen_device = -1, allowed_smem = 0, seen_smem = -1, max_grid = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device != seen_device || smem != seen_smem) {
        if (device != seen_device) allowed_smem = 0;
        if (smem > allowed_smem) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return static_cast<int>(err);
            allowed_smem = smem;
        }
        int n_sm = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        seen_device = device;
        seen_smem = smem;
        max_grid = per_sm * n_sm;
    }
    const int n_tiles = (n_rows + kRows - 1) / kRows;
    const int want = (n_tiles + kWarps - 1) / kWarps;
    const int grid = want < max_grid ? want : max_grid;
    const bool x_aligned16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    kernel<<<grid, kThreads, smem, stream>>>(x, n_rows, d_in, x_aligned16, weights, n_hidden, d_out, out, pre);
    return static_cast<int>(cudaGetLastError());
}

template <int DIN, int DOUT>
int launch_build(const float* x, int n_rows, int d_in, const __nv_bfloat16* weights, int n_hidden, int d_out,
                 float* out, __nv_bfloat16* pre, cudaStream_t stream) {
    if (pre != nullptr) return launch<DIN, DOUT, true>(x, n_rows, d_in, weights, n_hidden, d_out, out, pre, stream);
    return launch<DIN, DOUT, false>(x, n_rows, d_in, weights, n_hidden, d_out, out, pre, stream);
}

template <int DIN>
int launch_dout(int dout_pad, const float* x, int n_rows, int d_in, const __nv_bfloat16* weights, int n_hidden,
                int d_out, float* out, __nv_bfloat16* pre, cudaStream_t stream) {
    switch (dout_pad) {
        case 4: return launch_build<DIN, 4>(x, n_rows, d_in, weights, n_hidden, d_out, out, pre, stream);
        case 16: return launch_build<DIN, 16>(x, n_rows, d_in, weights, n_hidden, d_out, out, pre, stream);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}

}  // namespace

// x (n_rows, d_in) f32 contiguous; weights packed as W_0 (din_pad, width),
// n_hidden - 1 blocks (width, width) and W_out (width, dout_pad), bf16, each
// zero-padded, 16-byte aligned; out (n_rows, d_out) f32; pre null, or
// (n_hidden, n_rows, width) bf16 for the hidden pre-activations, 16-byte
// aligned. width 64, din_pad 32 or 64, dout_pad 4 or 16.
extern "C" int arcnerf_fused_mlp_fwd(const void* x, int n_rows, int d_in, int din_pad, const void* weights,
                                     int width, int n_hidden, int d_out, int dout_pad, void* out, void* pre,
                                     void* stream) {
    // the NGP nets of configs/ are all 64 wide, the only width built
    if (n_rows <= 0 || n_hidden < 1 || width != kW || d_in < 1 || d_in > din_pad || d_out < 1 || d_out > dout_pad ||
        (reinterpret_cast<uintptr_t>(weights) & 15) != 0 || (reinterpret_cast<uintptr_t>(pre) & 15) != 0)
        return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(x);
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(weights);
    float* op = static_cast<float*>(out);
    __nv_bfloat16* pp = static_cast<__nv_bfloat16*>(pre);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (din_pad) {
        case 32: return launch_dout<32>(dout_pad, xp, n_rows, d_in, wp, n_hidden, d_out, op, pp, s);
        case 64: return launch_dout<64>(dout_pad, xp, n_rows, d_in, wp, n_hidden, d_out, op, pp, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
