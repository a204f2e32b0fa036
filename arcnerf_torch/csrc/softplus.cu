// Kernel P: the SDF nets' softplus(beta x) / beta in one pass, its
// first-order backward in one pass, and that backward's backward (the
// eikonal loss's double backward) in one pass.
//
// Replaces no TPU kernel: the JAX package leaves the activation and its
// derivatives to XLA, which fuses them (arcnerf_tpu/models/base_modules/
// activation.py; jax.grad of jax.grad in sdf_model.py). PyTorch runs the
// activation as three elementwise passes, softplus(beta * x) / beta, and
// autograd adds three more for its backward and more again for the double
// backward. The plain versions are softplus_fwd_reference,
// softplus_bwd_reference and softplus_bwd2_reference
// (arcnerf_torch/ops/softplus.py).
//
// Every value is the three-op form's, bit for bit, as PyTorch's CUDA
// kernels compute it in f32 (an f32 input; opmath float):
//   forward  y = x * beta (the multiply by the scalar),
//            s = y > 20 ? y : log1p(exp(y)) (softplus at beta 1, threshold 20),
//            out = s * inv_beta (a true division by a CPU scalar runs as a
//            multiply by its f32 reciprocal, inv_beta = 1.f / beta);
//   backward, for d_out: g1 = d_out * inv_beta (the division's backward),
//            g2 = y > 20 ? g1 : g1 * z / (z + 1) with z = exp(y)
//            (softplus_backward), d_x = g2 * beta (the multiply's);
//   double backward, for gg (the gradient of d_x): gg2 = gg * beta;
//            d_dout = (y > 20 ? gg2 : gg2 * z / (z + 1)) * inv_beta;
//            g_x = (gg2 * g1) * (1 - sig) * sig * (y < 20) * beta with
//            sig = 1 / (1 + exp(-y)) (softplus_double_backward through
//            sigmoid_backward, then the multiply's backward).
// The expressions are written as PyTorch writes them, so the compiler
// (no fast math: NVCC_FLAGS in ops/cuda_lib.py) takes the same library
// expf and log1pf and the same IEEE division. Where autograd adds two
// gradients of x (the forward's path and the double backward's), it adds
// them at beta x, before the last multiply; here they meet after it, so a
// double backward's sum can differ from autograd's in its last bit.
//
// What bounds them on the H100: bytes. An element costs a few dozen f32
// instructions (one or two exp, one log1p, a division) and moves 8, 12 or
// 20 bytes (forward, backward, double backward), about 2.4, 3.6 and 6.0
// ns a thousand elements at 3.35 TB/s against ~0.5-1 ns of arithmetic.
// Design: one thread four consecutive elements as one 16-byte load a
// tensor (neighbouring threads on neighbouring addresses) where every
// pointer is 16-byte aligned, element by element otherwise and for the
// last n % 4; a grid-stride loop over a fixed grid. Sizes come from the
// host alone and no value is read back, so a CUDA graph can capture the
// launches.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // the H100's SMs x 8 blocks of 256 threads resident a SM
constexpr float kThreshold = 20.f;   // PyTorch's softplus threshold (of beta x)

struct Fwd {
    float beta, inv_beta;
    __device__ __forceinline__ float operator()(float x) const {
        const float y = x * beta;
        const float s = y > kThreshold ? y : log1pf(expf(y));
        return s * inv_beta;
    }
};

struct Bwd {
    float beta, inv_beta;
    __device__ __forceinline__ float operator()(float x, float d) const {
        const float y = x * beta;
        const float g1 = d * inv_beta;
        const float z = expf(y);
        const float g2 = y > kThreshold ? g1 : g1 * z / (z + 1.f);
        return g2 * beta;
    }
};

struct Bwd2 {
    float beta, inv_beta;
    // (g_x, g_dout) for the gradient gg of d_x
    __device__ __forceinline__ float2 operator()(float x, float d, float gg) const {
        const float y = x * beta;
        const float gg2 = gg * beta;
        const float z = expf(y);
        const float g_dout = (y > kThreshold ? gg2 : gg2 * z / (z + 1.f)) * inv_beta;
        const float a = gg2 * (d * inv_beta);
        const float sig = 1.f / (1.f + expf(-y));
        const float g_y = a * (1.f - sig) * sig * (y < kThreshold ? 1.f : 0.f);
        return make_float2(g_y * beta, g_dout);
    }
};

__device__ __forceinline__ float4 apply4(const Fwd& f, float4 x) {
    return make_float4(f(x.x), f(x.y), f(x.z), f(x.w));
}

__device__ __forceinline__ float4 apply4(const Bwd& f, float4 x, float4 d) {
    return make_float4(f(x.x, d.x), f(x.y, d.y), f(x.z, d.z), f(x.w, d.w));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    softplus_fwd_kernel(const float* __restrict__ x, long long n, Fwd f, float* __restrict__ out) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    long long done = 0;
    if (kVec) {
        const long long n4 = n >> 2;
        for (long long v = first; v < n4; v += stride)
            reinterpret_cast<float4*>(out)[v] = apply4(f, reinterpret_cast<const float4*>(x)[v]);
        done = n4 << 2;
    }
    for (long long i = done + first; i < n; i += stride) out[i] = f(x[i]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    softplus_bwd_kernel(const float* __restrict__ x, const float* __restrict__ d_out, long long n, Bwd f,
                        float* __restrict__ d_x) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    long long done = 0;
    if (kVec) {
        const long long n4 = n >> 2;
        for (long long v = first; v < n4; v += stride)
            reinterpret_cast<float4*>(d_x)[v] = apply4(f, reinterpret_cast<const float4*>(x)[v],
                                                       reinterpret_cast<const float4*>(d_out)[v]);
        done = n4 << 2;
    }
    for (long long i = done + first; i < n; i += stride) d_x[i] = f(x[i], d_out[i]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    softplus_bwd2_kernel(const float* __restrict__ x, const float* __restrict__ d_out, const float* __restrict__ gg,
                         long long n, Bwd2 f, float* __restrict__ g_x, float* __restrict__ g_dout) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    long long done = 0;
    if (kVec) {
        const long long n4 = n >> 2;
        for (long long v = first; v < n4; v += stride) {
            const float4 a = reinterpret_cast<const float4*>(x)[v];
            const float4 b = reinterpret_cast<const float4*>(d_out)[v];
            const float4 c = reinterpret_cast<const float4*>(gg)[v];
            const float2 r0 = f(a.x, b.x, c.x), r1 = f(a.y, b.y, c.y), r2 = f(a.z, b.z, c.z), r3 = f(a.w, b.w, c.w);
            reinterpret_cast<float4*>(g_x)[v] = make_float4(r0.x, r1.x, r2.x, r3.x);
            reinterpret_cast<float4*>(g_dout)[v] = make_float4(r0.y, r1.y, r2.y, r3.y);
        }
        done = n4 << 2;
    }
    for (long long i = done + first; i < n; i += stride) {
        const float2 r = f(x[i], d_out[i], gg[i]);
        g_x[i] = r.x;
        g_dout[i] = r.y;
    }
}

// Whether every pointer is 16-byte aligned: the float4 route.
bool aligned(std::initializer_list<const void*> ptrs) {
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    return true;
}

// The grid for n elements: a thread four of them (the float4 route) or one.
unsigned int blocks_for(long long n, bool vec) {
    const long long units = vec ? (n + 3) / 4 : n;
    const long long blocks = (units + kThreads - 1) / kThreads;
    return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// x (n,) f32 -> out (n,) f32: softplus(beta x) / beta.
extern "C" int arcnerf_softplus_fwd(const void* x, long long n, float beta, void* out, void* stream) {
    if (n <= 0) return ARCNERF_BAD_ARGUMENT;
    const Fwd f{beta, 1.f / beta};
    const bool vec = aligned({x, out});
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto xp = static_cast<const float*>(x);
    const auto op = static_cast<float*>(out);
    if (vec)
        softplus_fwd_kernel<true><<<blocks_for(n, true), kThreads, 0, s>>>(xp, n, f, op);
    else
        softplus_fwd_kernel<false><<<blocks_for(n, false), kThreads, 0, s>>>(xp, n, f, op);
    return static_cast<int>(cudaGetLastError());
}

// x, d_out (n,) f32 -> d_x (n,) f32: the forward's gradient for d_out.
extern "C" int arcnerf_softplus_bwd(const void* x, const void* d_out, long long n, float beta, void* d_x,
                                    void* stream) {
    if (n <= 0) return ARCNERF_BAD_ARGUMENT;
    const Bwd f{beta, 1.f / beta};
    const bool vec = aligned({x, d_out, d_x});
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto xp = static_cast<const float*>(x);
    const auto dp = static_cast<const float*>(d_out);
    const auto op = static_cast<float*>(d_x);
    if (vec)
        softplus_bwd_kernel<true><<<blocks_for(n, true), kThreads, 0, s>>>(xp, dp, n, f, op);
    else
        softplus_bwd_kernel<false><<<blocks_for(n, false), kThreads, 0, s>>>(xp, dp, n, f, op);
    return static_cast<int>(cudaGetLastError());
}

// x, d_out, gg (n,) f32 -> g_x, g_dout (n,) f32: the backward's gradients
// of x and of d_out for the gradient gg of d_x.
extern "C" int arcnerf_softplus_bwd2(const void* x, const void* d_out, const void* gg, long long n, float beta,
                                     void* g_x, void* g_dout, void* stream) {
    if (n <= 0) return ARCNERF_BAD_ARGUMENT;
    const Bwd2 f{beta, 1.f / beta};
    const bool vec = aligned({x, d_out, gg, g_x, g_dout});
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto xp = static_cast<const float*>(x);
    const auto dp = static_cast<const float*>(d_out);
    const auto gp = static_cast<const float*>(gg);
    const auto ox = static_cast<float*>(g_x);
    const auto od = static_cast<float*>(g_dout);
    if (vec)
        softplus_bwd2_kernel<true><<<blocks_for(n, true), kThreads, 0, s>>>(xp, dp, gp, n, f, ox, od);
    else
        softplus_bwd2_kernel<false><<<blocks_for(n, false), kThreads, 0, s>>>(xp, dp, gp, n, f, ox, od);
    return static_cast<int>(cudaGetLastError());
}
