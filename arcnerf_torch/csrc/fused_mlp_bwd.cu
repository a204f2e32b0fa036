// Kernel D: fused bias-free MLP backward from the saved pre-activations.
//
// Replaces the Pallas backward of arcnerf_tpu/ops/fused_mlp.py
// (_fused_mlp_bwd / _bwd_kernel). Inputs: x (B, D_in) f32, the output
// gradient g (B, D_out) f32, the chain's bf16 weights (the packed buffer of
// kernel A) and kernel A's saved bf16 hidden pre-activations. Outputs: dX
// (B, D_in) f32, and every layer's dW in f32 summed over all rows. The
// rounding is the Pallas kernel's, not XLA's autodiff: a layer's input is
// bf16(x) or bf16(relu(pre)); g stays f32 through the ReLU mask (pre > 0)
// and into dW = input^T g; g is rounded to bf16 only for the dX product
// g W^T, which accumulates in f32.
//
// What bounds it on the H100: per row and 64x64 layer, 4096 FMAs for dW
// and 4096 for dX, so ~2.1 GFLOP per layer at 2^18 rows - FP32-pipe work
// (tensor cores are later work), plus the cross-row reduction of dW. Design:
// one thread per row keeps its 64-wide g in registers and takes dX as in
// kernel A's forward (the weights sit in shared memory as f32, read as
// warp-broadcast float4s). For dW, each thread stages its row's layer
// input and g in shared memory; the block then reduces the 128 rows'
// outer products, each thread owning 4x4 tiles of dW, into a per-block
// f32 accumulator in shared memory that lives across the block's row
// tiles (a grid of about two blocks per SM loops over all tiles). At the
// end each block adds its accumulator into the global dW with one f32
// atomicAdd per element, so the sum order over blocks varies from run to
// run.

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // rows per tile = threads per block
constexpr int kStride = 64 + 4;  // staged row stride in floats: float4 stores hit distinct banks

// acc[k * N + j] += sum over the kRows staged rows of P[r][k] * G[r][j].
template <int K, int N>
__device__ __forceinline__ void reduce_layer(const float* __restrict__ P, const float* __restrict__ G,
                                             float* __restrict__ acc) {
    constexpr int TN = N / 4;
    for (int tile = threadIdx.x; tile < (K / 4) * TN; tile += kRows) {
        const int k0 = (tile / TN) * 4, j0 = (tile % TN) * 4;
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
        for (int r = 0; r < kRows; ++r) {
            const float4 p = *reinterpret_cast<const float4*>(P + r * kStride + k0);
            const float4 q = *reinterpret_cast<const float4*>(G + r * kStride + j0);
            const float pv[4] = {p.x, p.y, p.z, p.w};
            const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) s[a][b] = fmaf(pv[a], qv[b], s[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[(k0 + a) * N + j0 + b] += s[a][b];
    }
}

// o[k] = sum_j bf16(g[j]) * w[k * N + j], accumulated in f32.
template <int K, int N>
__device__ __forceinline__ void dense_t(const float (&g)[N], float (&o)[K], const float* __restrict__ w) {
    float gb[N];
#pragma unroll
    for (int j = 0; j < N; ++j) gb[j] = round_bf16(g[j]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const float4* row = reinterpret_cast<const float4*>(w + k * N);
        float s = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < N / 4; ++j4) {
            const float4 v = row[j4];
            s = fmaf(gb[4 * j4 + 0], v.x, s);
            s = fmaf(gb[4 * j4 + 1], v.y, s);
            s = fmaf(gb[4 * j4 + 2], v.z, s);
            s = fmaf(gb[4 * j4 + 3], v.w, s);
        }
        o[k] = s;
    }
}

// Stage n floats of this thread's row (n a multiple of 4).
template <int N>
__device__ __forceinline__ void stage(float* __restrict__ buf, const float (&v)[N]) {
    float4* dst = reinterpret_cast<float4*>(buf + threadIdx.x * kStride);
#pragma unroll
    for (int j4 = 0; j4 < N / 4; ++j4) dst[j4] = make_float4(v[4 * j4], v[4 * j4 + 1], v[4 * j4 + 2], v[4 * j4 + 3]);
}

// The input of a hidden layer: bf16(relu(pre)) - pre is bf16 already, so
// relu keeps it exact.
template <int W>
__device__ __forceinline__ void relu_of(const __nv_bfloat16* __restrict__ z, bool valid, float (&v)[W]) {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = valid ? fmaxf(__bfloat162float(z[k]), 0.f) : 0.f;
}

template <int W>
__device__ __forceinline__ void relu_mask(const __nv_bfloat16* __restrict__ z, bool valid, float (&g)[W]) {
#pragma unroll
    for (int k = 0; k < W; ++k) g[k] = (valid && __bfloat162float(z[k]) > 0.f) ? g[k] : 0.f;
}

template <int DIN, int W, int DOUT>
__global__ void __launch_bounds__(kRows) fused_mlp_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ gout, int n_rows, int d_in, int d_out,
        const __nv_bfloat16* __restrict__ weights, const __nv_bfloat16* __restrict__ pre, int n_hidden,
        float* __restrict__ dx, float* __restrict__ dw) {
    extern __shared__ float4 smem4[];
    float* ws = reinterpret_cast<float*>(smem4);
    const int n_w = DIN * W + (n_hidden - 1) * W * W + W * DOUT;
    float* acc = ws + n_w;
    float* P = acc + n_w;
    float* G = P + kRows * kStride;
    for (int i = threadIdx.x; i < n_w; i += kRows) {
        ws[i] = __bfloat162float(weights[i]);
        acc[i] = 0.f;
    }
    __syncthreads();
    const int w_out = DIN * W + (n_hidden - 1) * W * W;  // offset of W_out in ws / acc

    const int n_tiles = (n_rows + kRows - 1) / kRows;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int row = tile * kRows + threadIdx.x;
        const bool valid = row < n_rows;
        const int64_t r64 = valid ? row : 0;
        auto pre_row = [&](int l) { return pre + (static_cast<int64_t>(l) * n_rows + r64) * W; };

        // output layer: input bf16(relu(pre[n_hidden - 1])), gradient g
        float go[DOUT];
#pragma unroll
        for (int j = 0; j < DOUT; ++j) go[j] = (valid && j < d_out) ? gout[r64 * d_out + j] : 0.f;
        {
            float v[W];
            relu_of<W>(pre_row(n_hidden - 1), valid, v);
            stage<W>(P, v);
            stage<DOUT>(G, go);
        }
        __syncthreads();
        reduce_layer<W, DOUT>(P, G, acc + w_out);
        __syncthreads();
        float gh[W];
        dense_t<W, DOUT>(go, gh, ws + w_out);

        // hidden layers W x W, last to second
        for (int l = n_hidden - 1; l >= 1; --l) {
            relu_mask<W>(pre_row(l), valid, gh);
            float v[W];
            relu_of<W>(pre_row(l - 1), valid, v);
            stage<W>(P, v);
            stage<W>(G, gh);
            __syncthreads();
            const int off = DIN * W + (l - 1) * W * W;
            reduce_layer<W, W>(P, G, acc + off);
            __syncthreads();
            float t[W];
            dense_t<W, W>(gh, t, ws + off);
#pragma unroll
            for (int k = 0; k < W; ++k) gh[k] = t[k];
        }

        // first layer: input bf16(x), zero-padded to DIN
        relu_mask<W>(pre_row(0), valid, gh);
        {
            float v[DIN];
            const float* xr = x + r64 * d_in;
#pragma unroll
            for (int k = 0; k < DIN; ++k) v[k] = (valid && k < d_in) ? round_bf16(xr[k]) : 0.f;
            stage<DIN>(P, v);
            stage<W>(G, gh);
        }
        __syncthreads();
        reduce_layer<DIN, W>(P, G, acc);
        __syncthreads();
        float o[DIN];
        dense_t<DIN, W>(gh, o, ws);
        if (valid) {
            float* dr = dx + r64 * d_in;
#pragma unroll
            for (int k = 0; k < DIN; ++k)
                if (k < d_in) dr[k] = o[k];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_w; i += kRows) atomicAdd(dw + i, acc[i]);
}

template <int DIN, int W, int DOUT>
int launch(const float* x, const float* g, int n_rows, int d_in, int d_out, const __nv_bfloat16* weights,
           const __nv_bfloat16* pre, int n_hidden, float* dx, float* dw, cudaStream_t stream) {
    const int n_w = DIN * W + (n_hidden - 1) * W * W + W * DOUT;
    const size_t smem = sizeof(float) * (2 * n_w + 2 * kRows * kStride);
    auto kernel = fused_mlp_bwd_kernel<DIN, W, DOUT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, n_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n_rows + kRows - 1) / kRows;
    const int grid = n_tiles < 2 * n_sm ? n_tiles : 2 * n_sm;
    kernel<<<grid, kRows, smem, stream>>>(x, g, n_rows, d_in, d_out, weights, pre, n_hidden, dx, dw);
    return static_cast<int>(cudaGetLastError());
}

template <int DIN, int W>
int launch_dout(int dout_pad, const float* x, const float* g, int n_rows, int d_in, int d_out,
                const __nv_bfloat16* weights, const __nv_bfloat16* pre, int n_hidden, float* dx, float* dw,
                cudaStream_t stream) {
    switch (dout_pad) {
        case 4: return launch<DIN, W, 4>(x, g, n_rows, d_in, d_out, weights, pre, n_hidden, dx, dw, stream);
        case 16: return launch<DIN, W, 16>(x, g, n_rows, d_in, d_out, weights, pre, n_hidden, dx, dw, stream);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}

}  // namespace

// x (n_rows, d_in) f32; g (n_rows, d_out) f32; weights packed as for
// arcnerf_fused_mlp_fwd (DIN = din_pad, DOUT = dout_pad); pre (n_hidden,
// n_rows, width) bf16 from the forward; dx (n_rows, d_in) f32; dw f32 of the
// packed layout, zeroed by the caller, accumulated into.
extern "C" int arcnerf_fused_mlp_bwd(const void* x, const void* g, int n_rows, int d_in, int din_pad,
                                     const void* weights, int width, int n_hidden, int d_out, int dout_pad,
                                     const void* pre, void* dx, void* dw, void* stream) {
    if (n_rows <= 0 || n_hidden < 1 || width != 64 || d_in > din_pad || d_out > dout_pad) return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(x);
    const float* gp = static_cast<const float*>(g);
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(weights);
    const __nv_bfloat16* pp = static_cast<const __nv_bfloat16*>(pre);
    float* dxp = static_cast<float*>(dx);
    float* dwp = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (din_pad) {
        case 32: return launch_dout<32, 64>(dout_pad, xp, gp, n_rows, d_in, d_out, wp, pp, n_hidden, dxp, dwp, s);
        case 64: return launch_dout<64, 64>(dout_pad, xp, gp, n_rows, d_in, d_out, wp, pp, n_hidden, dxp, dwp, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
