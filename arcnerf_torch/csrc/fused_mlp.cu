// Kernel A: fused bias-free MLP forward (bf16 operands, f32 accumulation).
//
// Replaces the Pallas forward of arcnerf_tpu/ops/fused_mlp.py
// (_run_forward / _fwd_kernel, no save_pre). Semantics: the input is
// rounded to bf16, every layer accumulates exact bf16 x bf16 products in
// f32, ReLU runs in f32 on every layer but the last, and every layer's
// output is rounded to bf16; the result is written as f32.
//
// What bounds it on the H100: at the serving shapes (2^18 rows, 32->64->16
// and 32->64->64->4 after padding) the chain is 3-6.4 kFLOP per row read
// through ~128 input bytes, so it is compute-bound on the FMA pipes long
// before HBM. Design: one thread owns one row and keeps its activations in
// registers (template widths, fully unrolled); all weights of the chain sit
// in shared memory as f32 (<= 53 KB) and every k-step reads one float4 of a
// weight row that all lanes of the warp share (a broadcast, no bank
// conflicts), feeding 4 independent FMA chains. No intermediate activation
// ever leaves the SM. Tensor cores (mma.sync / wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 128;

template <int K, int N>
__device__ __forceinline__ void dense(const float (&h)[K], float (&o)[N], const float* __restrict__ w) {
#pragma unroll
    for (int j = 0; j < N; ++j) o[j] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const float hk = h[k];
        const float4* row = reinterpret_cast<const float4*>(w + k * N);
#pragma unroll
        for (int j4 = 0; j4 < N / 4; ++j4) {
            const float4 v = row[j4];
            o[4 * j4 + 0] = fmaf(hk, v.x, o[4 * j4 + 0]);
            o[4 * j4 + 1] = fmaf(hk, v.y, o[4 * j4 + 1]);
            o[4 * j4 + 2] = fmaf(hk, v.z, o[4 * j4 + 2]);
            o[4 * j4 + 3] = fmaf(hk, v.w, o[4 * j4 + 3]);
        }
    }
}

// weights: one bf16 buffer holding W_0 (DIN x W), n_hidden-1 blocks of
// (W x W) and W_out (W x DOUT), each zero-padded to those widths.
template <int DIN, int W, int DOUT>
__global__ void __launch_bounds__(kRowsPerBlock) fused_mlp_fwd_kernel(
        const float* __restrict__ x, int n_rows, int d_in, const __nv_bfloat16* __restrict__ weights,
        int n_hidden, int d_out, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);
    const int n_w = DIN * W + (n_hidden - 1) * W * W + W * DOUT;
    for (int i = threadIdx.x; i < n_w; i += blockDim.x) ws[i] = __bfloat162float(weights[i]);
    __syncthreads();

    const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
    if (row >= n_rows) return;

    float xin[DIN];
    const float* xr = x + static_cast<int64_t>(row) * d_in;
#pragma unroll
    for (int k = 0; k < DIN; ++k) xin[k] = k < d_in ? round_bf16(xr[k]) : 0.f;

    float h[W];
    dense<DIN, W>(xin, h, ws);
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = round_bf16(fmaxf(h[j], 0.f));
    const float* wl = ws + DIN * W;
    for (int l = 1; l < n_hidden; ++l, wl += W * W) {
        float t[W];
        dense<W, W>(h, t, wl);
#pragma unroll
        for (int j = 0; j < W; ++j) h[j] = round_bf16(fmaxf(t[j], 0.f));
    }
    float o[DOUT];
    dense<W, DOUT>(h, o, wl);
    float* orow = out + static_cast<int64_t>(row) * d_out;
#pragma unroll
    for (int j = 0; j < DOUT; ++j)
        if (j < d_out) orow[j] = round_bf16(o[j]);
}

template <int DIN, int W, int DOUT>
int launch(const float* x, int n_rows, int d_in, const __nv_bfloat16* weights, int n_hidden, int d_out,
           float* out, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (DIN * W + (n_hidden - 1) * W * W + W * DOUT);
    auto kernel = fused_mlp_fwd_kernel<DIN, W, DOUT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
    kernel<<<grid, kRowsPerBlock, smem, stream>>>(x, n_rows, d_in, weights, n_hidden, d_out, out);
    return static_cast<int>(cudaGetLastError());
}

template <int DIN, int W>
int launch_dout(int dout_pad, const float* x, int n_rows, int d_in, const __nv_bfloat16* weights,
                int n_hidden, int d_out, float* out, cudaStream_t stream) {
    switch (dout_pad) {
        case 4: return launch<DIN, W, 4>(x, n_rows, d_in, weights, n_hidden, d_out, out, stream);
        case 16: return launch<DIN, W, 16>(x, n_rows, d_in, weights, n_hidden, d_out, out, stream);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}

}  // namespace

// x (n_rows, d_in) f32 contiguous; weights packed as described above with
// DIN = din_pad and DOUT = dout_pad; out (n_rows, d_out) f32.
extern "C" int arcnerf_fused_mlp_fwd(const void* x, int n_rows, int d_in, int din_pad, const void* weights,
                                     int width, int n_hidden, int d_out, int dout_pad, void* out,
                                     void* stream) {
    // the NGP nets of configs/ are all 64 wide; each width is a separate
    // fully unrolled instantiation, so only that one is built
    if (n_rows <= 0 || n_hidden < 1 || width != 64 || d_in > din_pad || d_out > dout_pad) return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(x);
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(weights);
    float* op = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (din_pad) {
        case 32: return launch_dout<32, 64>(dout_pad, xp, n_rows, d_in, wp, n_hidden, d_out, op, s);
        case 64: return launch_dout<64, 64>(dout_pad, xp, n_rows, d_in, wp, n_hidden, d_out, op, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
