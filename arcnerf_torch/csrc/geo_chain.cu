// Kernels M and N: NeuS-NGP's geometry chain (the recipe's GeoNet, 32 -> 64
// -> 17 in f32, softplus(beta z) / beta, no bias) with the sdf's input
// gradient, and one explicit first-order backward of both.
//
// Replaces no TPU kernel: the JAX package takes the chain's input gradient
// with jax.grad and the eikonal loss's double backward with jax.grad of
// jax.grad (arcnerf_tpu/models/sdf_model.py, geo_with_grad). The plain
// versions are geo_chain_fwd_reference and geo_chain_bwd_reference
// (arcnerf_torch/ops/geo_chain.py).
//
// M (geo_chain_fwd_kernel), per row of enc (N, 32), with W1 (32, 64), W2
// (64, 17), w = W2[:, 0] and sigma = softplus'(beta z):
//   z = enc W1, a = softplus(beta z) / beta, out = a W2 (N, 17),
//   g = d out[:, 0] / d enc = (sigma * w) W1^T (N, 32).
// N (geo_chain_bwd_kernel), for the gradients d_out (N, 17) and d_g (N, 32):
//   u = d_g W1, v = sigma * w,
//   dz = u * w * sigma' + (d_out W2^T) * sigma,
//   d_enc = dz W1^T (N, 32), and each block's partial sums of
//   dW1 = d_g^T v + enc^T dz and dW2 = a^T d_out (+ sum(u * sigma) in column 0);
// geo_chain_reduce_kernel adds the blocks' partials in a fixed order (no
// atomics: the same inputs give the same bits). N recomputes z rather than
// reading it back: 2048 FMAs a row cost less than writing and reading 256
// bytes a row.
// softplus is PyTorch's: above the threshold 20 (of beta z) a = z, sigma =
// 1, sigma' = 0; below it a = log1p(e) / beta, sigma = e / (e + 1), sigma' =
// beta e / ((e + 1)(e + 1)) with e = exp(beta z); a divides by beta as
// PyTorch's CUDA division by a number does, times the f32 reciprocal. The
// quotients take the reciprocal's estimate and one Newton step
// (``quotient``): on the card they equal the IEEE division bit for bit on a
// step's 2^18 rows x 64 units, at a third of its cost.
//
// What bounds them on the H100: f32 FMAs (the configuration states f32 for
// this chain, so no TF32 or bf16 tensor-core product): M 5,184 a row, N
// 10,368 a row besides its recompute of z, about 8 GFLOP for a step's 2^18
// rows (~0.12 ms at the card's 67 TFLOP/s); the bytes (enc, g, out, d_out,
// d_g, d_enc: ~0.75 KB a row) take ~0.06 ms. Shared memory is the nearer
// wall: it serves 128 bytes a clock an SM against 128 FMAs, so a thread has
// to use each value it reads there several times. Design:
// - the weights (12.5 KB) sit in shared memory once a block (W1 as it is and
//   transposed, W2 transposed, rows padded so that reads meet no bank
//   conflict); blocks walk tiles of 64 rows (M three an SM, N two), the
//   tile's inputs staged through shared memory by coalesced reads;
// - z (and in N u = d_g W1 and d_out W2^T) as register tiles of two rows x
//   eight hidden units a thread, each weight read feeding two rows;
//   softplus there; a, v (and dz, u * sigma) to shared memory;
// - the products over the hidden units (M: out = a W2, g = v W1^T; N: d_enc
//   = dz W1^T and the weight-gradient sums) as register tiles over those;
//   N's weight-gradient sums stay in registers over the block's tiles
//   (two halves of each tile's rows, added at the end) and leave as one
//   partial a block.
// Both read the valid row count from the device (rows at or past it come
// out 0), so they are launched at fixed sizes with no host read and can be
// captured in a CUDA graph.

#include "common.cuh"

namespace {

constexpr int kIn = 32, kHid = 64, kOut = 17;
constexpr int kInPad = 36;   // shared-memory row strides: 16-byte rows, reads free of bank conflicts
constexpr int kOutPad = 20;
constexpr int kHidPad = 68;
constexpr float kThreshold = 20.f;  // PyTorch's softplus threshold
constexpr int kTile = 64;           // M and N: rows a tile
constexpr int kThreads = 256;       // M and N: threads a block
constexpr int kFwdBlocks = 3;       // M: blocks an SM
constexpr int kFwdGrid = 396;       // M: blocks at most (three an SM of the H100)
constexpr int kParts = 264;         // N: blocks at most (two an SM of the H100), one partial each
constexpr int kPartSize = kIn * kHid + kHid * kOut;
constexpr int kSlices = 8;          // the reduce: partial sums a column, added in a fixed order

__device__ __forceinline__ int64_t valid_rows(const int64_t* n_valid, int64_t n_rows) {
    if (n_valid == nullptr) return n_rows;
    const int64_t n = *n_valid;
    return n < 0 ? 0 : (n < n_rows ? n : n_rows);
}

// x / y for the quotients below (y in [1, (exp(20) + 1)^2]): the reciprocal's
// estimate, the quotient, one Newton step on its residual; the IEEE division
// (__fdiv_rn) is a called routine that took a third of N's time
__device__ __forceinline__ float quotient(float x, float y) {
    const float r = __fdividef(1.f, y);
    const float q = __fmul_rn(x, r);
    return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// softplus(beta z) / beta (a) and its derivative sigma, PyTorch's formulas
__device__ __forceinline__ void softplus(float z, float beta, float inv_beta, float& a, float& s) {
    const float y = __fmul_rn(z, beta);
    if (y > kThreshold) {
        a = __fmul_rn(y, inv_beta);
        s = 1.f;
    } else {
        const float e = expf(y);
        a = __fmul_rn(log1pf(e), inv_beta);
        s = quotient(e, __fadd_rn(e, 1.f));
    }
}

// the same and sigma' = d sigma / d z
__device__ __forceinline__ void softplus2(float z, float beta, float inv_beta, float& a, float& s, float& ds) {
    const float y = __fmul_rn(z, beta);
    if (y > kThreshold) {
        a = __fmul_rn(y, inv_beta);
        s = 1.f;
        ds = 0.f;
    } else {
        const float e = expf(y), e1 = __fadd_rn(e, 1.f);
        a = __fmul_rn(log1pf(e), inv_beta);
        s = quotient(e, e1);
        ds = quotient(__fmul_rn(beta, e), __fmul_rn(e1, e1));
    }
}

// W1 (32, 64) as it is (w1r[i * kHid + j]) and transposed (w1t[j * stride + i])
__device__ __forceinline__ void load_w1(const float* __restrict__ w1, float* w1r, float* w1t, int stride) {
    for (int e = threadIdx.x; e < kIn * kHid; e += blockDim.x) {
        const float w = w1[e];
        w1r[e] = w;
        w1t[(e % kHid) * stride + e / kHid] = w;
    }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

struct FwdShared {
    float w1r[kIn * kHid];
    float w1t[kHid * kInPad];
    float w2t[kOut * kHidPad];
    float enc[kTile * kInPad];  // the tile's enc rows, then its out rows (kOut a row)
    float a[kTile * kHidPad];
    float v[kTile * kHidPad];
};

// z = enc W1 of rows 2 p, 2 p + 1 and the hidden units 4 (q + 8 m) + (0..3),
// m = 0, 1, for p = t >> 3, q = t & 7: 16 independent sums in the inputs'
// order; a weight read from shared memory feeds two FMAs (eight threads
// share each input read). With ``y`` (d_g) also u = d_g W1 beside z.
template <bool WITH_U>
__device__ __forceinline__ void tile_z(const float* enc, const float* dg, const float* w1r, int p, int q,
                                       float (&z)[2][8], float (&u)[2][8]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int m = 0; m < 8; ++m) z[rr][m] = u[rr][m] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kIn / 4; ++c) {
        float xe[2][4], yg[2][4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            const float4 e4 = ld4(enc + (2 * p + rr) * kInPad + 4 * c);
            xe[rr][0] = e4.x, xe[rr][1] = e4.y, xe[rr][2] = e4.z, xe[rr][3] = e4.w;
            if (WITH_U) {
                const float4 g4 = ld4(dg + (2 * p + rr) * kInPad + 4 * c);
                yg[rr][0] = g4.x, yg[rr][1] = g4.y, yg[rr][2] = g4.z, yg[rr][3] = g4.w;
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
            const float* wr = w1r + (4 * c + ii) * kHid + 4 * q;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const float4 w = ld4(wr + 32 * m);
                const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int b = 0; b < 4; ++b) {
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr) {
                        z[rr][4 * m + b] = __fmaf_rn(xe[rr][ii], wq[b], z[rr][4 * m + b]);
                        if (WITH_U) u[rr][4 * m + b] = __fmaf_rn(yg[rr][ii], wq[b], u[rr][4 * m + b]);
                    }
                }
            }
        }
    }
}

// out[r][i] = sum_j h[r][j] W[i][j] (the rows' K = 64 products with W1^T)
// for rows 2 rp, 2 rp + 1 and columns c0..c0+3, j in order
__device__ __forceinline__ void tile_w1t(const float* h, const float* w1t, int rp, int c0, float (&o)[2][4]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) o[k][0] = o[k][1] = o[k][2] = o[k][3] = 0.f;
#pragma unroll 4
    for (int j4 = 0; j4 < kHid / 4; ++j4) {
        const float4 za = ld4(h + rp * kHidPad + 4 * j4), zb = ld4(h + (rp + 1) * kHidPad + 4 * j4);
        const float zqa[4] = {za.x, za.y, za.z, za.w}, zqb[4] = {zb.x, zb.y, zb.z, zb.w};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const float4 w = ld4(w1t + (4 * j4 + b) * kInPad + c0);
            o[0][0] = __fmaf_rn(zqa[b], w.x, o[0][0]), o[1][0] = __fmaf_rn(zqb[b], w.x, o[1][0]);
            o[0][1] = __fmaf_rn(zqa[b], w.y, o[0][1]), o[1][1] = __fmaf_rn(zqb[b], w.y, o[1][1]);
            o[0][2] = __fmaf_rn(zqa[b], w.z, o[0][2]), o[1][2] = __fmaf_rn(zqb[b], w.z, o[1][2]);
            o[0][3] = __fmaf_rn(zqa[b], w.w, o[0][3]), o[1][3] = __fmaf_rn(zqb[b], w.w, o[1][3]);
        }
    }
}

__device__ __forceinline__ void load_w2t(const float* __restrict__ w2, float* w2t) {
    for (int e = threadIdx.x; e < kHid * kOut; e += blockDim.x) w2t[(e % kOut) * kHidPad + e / kOut] = w2[e];
}

__global__ void __launch_bounds__(kThreads, kFwdBlocks) geo_chain_fwd_kernel(
        const float* __restrict__ enc, int64_t n_rows, const int64_t* __restrict__ n_valid,
        const float* __restrict__ w1, const float* __restrict__ w2, float beta, float inv_beta,
        float* __restrict__ out, float* __restrict__ g) {
    extern __shared__ uint4 smem4[];
    FwdShared& sh = *reinterpret_cast<FwdShared*>(smem4);
    const int t = threadIdx.x;
    const int64_t nv = valid_rows(n_valid, n_rows);
    load_w1(w1, sh.w1r, sh.w1t, kInPad);
    load_w2t(w2, sh.w2t);

    const int64_t n_tiles = (n_rows + kTile - 1) / kTile;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t r0 = tile * kTile;
        const int n_here = static_cast<int>(min(static_cast<int64_t>(kTile), n_rows - r0));
        const int n_live = static_cast<int>(max(static_cast<int64_t>(0), min(static_cast<int64_t>(n_here), nv - r0)));
        if (n_live == 0) {  // past the valid rows: zeros
            for (int e = t; e < n_here * kOut; e += kThreads) out[r0 * kOut + e] = 0.f;
            for (int e = t; e < n_here * kIn; e += kThreads) g[r0 * kIn + e] = 0.f;
            continue;
        }
        __syncthreads();  // the previous tile's reads are done
        for (int q = t; q < kTile * (kIn / 4); q += kThreads) {
            const int r = q / (kIn / 4), c = q % (kIn / 4);
            float4 e4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < n_live) e4 = reinterpret_cast<const float4*>(enc + (r0 + r) * kIn)[c];
            *reinterpret_cast<float4*>(sh.enc + r * kInPad + 4 * c) = e4;
        }
        __syncthreads();

        // z, then a and v = sigma W2[:, 0] into shared memory
        {
            const int p = t >> 3, q = t & 7;
            float z[2][8], unused[2][8];
            tile_z<false>(sh.enc, nullptr, sh.w1r, p, q, z, unused);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const float4 w04 = ld4(sh.w2t + 4 * q + 32 * m);  // W2[j, 0]
                const float w0[4] = {w04.x, w04.y, w04.z, w04.w};
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    float a[4], v[4];
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        float s;
                        softplus(z[rr][4 * m + b], beta, inv_beta, a[b], s);
                        v[b] = __fmul_rn(s, w0[b]);
                    }
                    const int o = (2 * p + rr) * kHidPad + 4 * q + 32 * m;
                    *reinterpret_cast<float4*>(sh.a + o) = make_float4(a[0], a[1], a[2], a[3]);
                    *reinterpret_cast<float4*>(sh.v + o) = make_float4(v[0], v[1], v[2], v[3]);
                }
            }
        }
        __syncthreads();

        // g = v W1^T, two rows x four columns a thread, straight to g
        {
            const int c0 = 4 * (t & 7), rp = 2 * (t >> 3);
            float o[2][4];
            tile_w1t(sh.v, sh.w1t, rp, c0, o);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                if (rp + k < n_here)
                    *reinterpret_cast<float4*>(g + (r0 + rp + k) * kIn + c0) =
                        k + rp < n_live ? make_float4(o[k][0], o[k][1], o[k][2], o[k][3])
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        // out = a W2: row t >> 2, columns kq, kq + 4, kq + 8, kq + 12 (and 16 for kq 0), j in order
        {
            const int r = t >> 2, kq = t & 3;
            float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
            for (int j4 = 0; j4 < kHid / 4; ++j4) {
                const float4 a4 = ld4(sh.a + r * kHidPad + 4 * j4);
                const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
                for (int n = 0; n < 5; ++n) {
                    if (n < 4 || kq == 0) {
                        const float4 w = ld4(sh.w2t + (n < 4 ? kq + 4 * n : 16) * kHidPad + 4 * j4);
                        o[n] = __fmaf_rn(aq[0], w.x, o[n]);
                        o[n] = __fmaf_rn(aq[1], w.y, o[n]);
                        o[n] = __fmaf_rn(aq[2], w.z, o[n]);
                        o[n] = __fmaf_rn(aq[3], w.w, o[n]);
                    }
                }
            }
            // through shared memory (the enc rows are read), then whole lines to out
            const bool live = r < n_live;
#pragma unroll
            for (int n = 0; n < 4; ++n) sh.enc[r * kOut + kq + 4 * n] = live ? o[n] : 0.f;
            if (kq == 0) sh.enc[r * kOut + 16] = live ? o[4] : 0.f;
        }
        __syncthreads();
        for (int e = t; e < n_here * kOut; e += kThreads) out[r0 * kOut + e] = sh.enc[e];
    }
}

struct BwdShared {
    float w1r[kIn * kHid];
    float w1t[kHid * kInPad];
    float w2t[kOut * kHidPad];  // W2 transposed: row k holds W2[:, k]
    float enc[kTile * kInPad];
    float dg[kTile * kInPad];
    float dout[kTile * kOutPad];
    float dz[kTile * kHidPad];
    float v[kTile * kHidPad];
    float a[kTile * kHidPad];
    float us[kTile * kHidPad];
};

__global__ void __launch_bounds__(kThreads, 2) geo_chain_bwd_kernel(
        const float* __restrict__ enc, int64_t n_rows, const int64_t* __restrict__ n_valid,
        const float* __restrict__ w1, const float* __restrict__ w2, const float* __restrict__ d_out,
        const float* __restrict__ d_g, float beta, float inv_beta, float* __restrict__ d_enc,
        float* __restrict__ parts) {
    extern __shared__ uint4 smem4[];
    BwdShared& sh = *reinterpret_cast<BwdShared*>(smem4);
    const int t = threadIdx.x;
    const int64_t nv = valid_rows(n_valid, n_rows);
    load_w1(w1, sh.w1r, sh.w1t, kInPad);
    load_w2t(w2, sh.w2t);

    // phase 2's register tiles: the tile's rows in two halves h; dW1 rows
    // i0..i0+3 x columns j0..j0+3; dW2 rows j0..j0+3 x columns 2 kg, 2 kg + 1
    // (and 16 for kg 7; the u * sigma sums join column 0 for kg 0)
    const int h = t >> 7, tt = t & 127;
    const int i0 = 4 * (tt >> 4), j0 = 4 * (tt & 15), kg = tt >> 4;
    float acc1[4][4], acc2[4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc1[a][b] = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b) acc2[a][b] = 0.f;
    }

    const int64_t n_tiles = (n_rows + kTile - 1) / kTile;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t r0 = tile * kTile;
        const int n_here = static_cast<int>(min(static_cast<int64_t>(kTile), n_rows - r0));
        const int n_live = static_cast<int>(max(static_cast<int64_t>(0), min(static_cast<int64_t>(n_here), nv - r0)));
        if (n_live == 0) {  // past the valid rows: d_enc 0
            for (int e = t; e < n_here * kIn; e += kThreads) d_enc[r0 * kIn + e] = 0.f;
            continue;
        }
        __syncthreads();  // the previous tile's reads are done
        // phase 0: the tile's enc, d_g, d_out rows (zeros past the valid ones)
        for (int q = t; q < kTile * (kIn / 4); q += kThreads) {
            const int r = q / (kIn / 4), c = q % (kIn / 4);
            float4 e4 = make_float4(0.f, 0.f, 0.f, 0.f), g4 = e4;
            if (r < n_live) {
                e4 = reinterpret_cast<const float4*>(enc + (r0 + r) * kIn)[c];
                g4 = reinterpret_cast<const float4*>(d_g + (r0 + r) * kIn)[c];
            }
            *reinterpret_cast<float4*>(sh.enc + r * kInPad + 4 * c) = e4;
            *reinterpret_cast<float4*>(sh.dg + r * kInPad + 4 * c) = g4;
        }
        for (int e = t; e < kTile * kOut; e += kThreads) {
            const int r = e / kOut;
            sh.dout[r * kOutPad + e % kOut] = r < n_live ? d_out[r0 * kOut + e] : 0.f;
        }
        __syncthreads();

        // phase 1: thread (p, q) takes rows 2 p, 2 p + 1 and the hidden units 4 (q + 8 m) + (0..3), m = 0, 1:
        // their z, u and (d_out W2^T) as 48 independent sums in the inputs' order
        {
            const int p = t >> 3, q = t & 7;
            float z[2][8], u[2][8], tj[2][8];
            tile_z<true>(sh.enc, sh.dg, sh.w1r, p, q, z, u);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
                for (int m = 0; m < 8; ++m) tj[rr][m] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < kOut; ++k) {
                const float d[2] = {sh.dout[2 * p * kOutPad + k], sh.dout[(2 * p + 1) * kOutPad + k]};
                const float* wk = sh.w2t + k * kHidPad + 4 * q;
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const float4 w = ld4(wk + 32 * m);
                    const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
#pragma unroll
                        for (int rr = 0; rr < 2; ++rr) tj[rr][4 * m + b] = __fmaf_rn(d[rr], wq[b], tj[rr][4 * m + b]);
                    }
                }
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const float4 w04 = ld4(sh.w2t + 4 * q + 32 * m);  // W2[j, 0]
                const float w0[4] = {w04.x, w04.y, w04.z, w04.w};
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    float dz[4], v[4], a[4], us[4];
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int k = 4 * m + b;
                        float s, ds;
                        softplus2(z[rr][k], beta, inv_beta, a[b], s, ds);
                        dz[b] = __fmaf_rn(tj[rr][k], s, __fmul_rn(__fmul_rn(u[rr][k], w0[b]), ds));
                        v[b] = __fmul_rn(s, w0[b]);
                        us[b] = __fmul_rn(u[rr][k], s);
                    }
                    const int o = (2 * p + rr) * kHidPad + 4 * q + 32 * m;
                    *reinterpret_cast<float4*>(sh.dz + o) = make_float4(dz[0], dz[1], dz[2], dz[3]);
                    *reinterpret_cast<float4*>(sh.v + o) = make_float4(v[0], v[1], v[2], v[3]);
                    *reinterpret_cast<float4*>(sh.a + o) = make_float4(a[0], a[1], a[2], a[3]);
                    *reinterpret_cast<float4*>(sh.us + o) = make_float4(us[0], us[1], us[2], us[3]);
                }
            }
        }
        __syncthreads();

        // phase 2: dW1 += enc^T dz + d_g^T v and dW2 += a^T d_out over this half's rows
#pragma unroll 4
        for (int r = h * (kTile / 2); r < (h + 1) * (kTile / 2); ++r) {
            const float4 e4 = ld4(sh.enc + r * kInPad + i0), g4 = ld4(sh.dg + r * kInPad + i0);
            const float4 z4 = ld4(sh.dz + r * kHidPad + j0), v4 = ld4(sh.v + r * kHidPad + j0);
            const float e[4] = {e4.x, e4.y, e4.z, e4.w}, gq[4] = {g4.x, g4.y, g4.z, g4.w};
            const float zq[4] = {z4.x, z4.y, z4.z, z4.w}, vq[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
                for (int b = 0; b < 4; ++b) acc1[a][b] = __fmaf_rn(gq[a], vq[b], __fmaf_rn(e[a], zq[b], acc1[a][b]));
            }
            const float4 a4 = ld4(sh.a + r * kHidPad + j0);
            const float aq[4] = {a4.x, a4.y, a4.z, a4.w};
            const float2 d2 = *reinterpret_cast<const float2*>(sh.dout + r * kOutPad + 2 * kg);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                acc2[b][0] = __fmaf_rn(aq[b], d2.x, acc2[b][0]);
                acc2[b][1] = __fmaf_rn(aq[b], d2.y, acc2[b][1]);
            }
            if (kg == 0) {
                const float4 u4 = ld4(sh.us + r * kHidPad + j0);
                acc2[0][0] = __fadd_rn(acc2[0][0], u4.x);
                acc2[1][0] = __fadd_rn(acc2[1][0], u4.y);
                acc2[2][0] = __fadd_rn(acc2[2][0], u4.z);
                acc2[3][0] = __fadd_rn(acc2[3][0], u4.w);
            } else if (kg == 7) {
                const float d16 = sh.dout[r * kOutPad + 16];
#pragma unroll
                for (int b = 0; b < 4; ++b) acc2[b][2] = __fmaf_rn(aq[b], d16, acc2[b][2]);
            }
        }

        // phase 2: d_enc = dz W1^T, two rows x four columns a thread
        {
            const int c0 = 4 * (t & 7), rp = 2 * (t >> 3);
            float o[2][4];
            tile_w1t(sh.dz, sh.w1t, rp, c0, o);
#pragma unroll
            for (int k = 0; k < 2; ++k)
                if (rp + k < n_here)
                    *reinterpret_cast<float4*>(d_enc + (r0 + rp + k) * kIn + c0) =
                        make_float4(o[k][0], o[k][1], o[k][2], o[k][3]);
        }
    }

    // the block's partial: the second half's sums through shared memory, added to the first's
    __syncthreads();
    float* spill = sh.dz;
    if (h == 1) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) spill[(a * 4 + b) * 128 + tt] = acc1[a][b];
#pragma unroll
            for (int b = 0; b < 3; ++b) spill[(16 + a * 3 + b) * 128 + tt] = acc2[a][b];
        }
    }
    __syncthreads();
    if (h == 0) {
        float* part = parts + static_cast<int64_t>(blockIdx.x) * kPartSize;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            float s[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) s[b] = __fadd_rn(acc1[a][b], spill[(a * 4 + b) * 128 + tt]);
            *reinterpret_cast<float4*>(part + (i0 + a) * kHid + j0) = make_float4(s[0], s[1], s[2], s[3]);
        }
        float* part2 = part + kIn * kHid;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            part2[(j0 + b) * kOut + 2 * kg] = __fadd_rn(acc2[b][0], spill[(16 + b * 3) * 128 + tt]);
            part2[(j0 + b) * kOut + 2 * kg + 1] = __fadd_rn(acc2[b][1], spill[(16 + b * 3 + 1) * 128 + tt]);
            if (kg == 7) part2[(j0 + b) * kOut + 16] = __fadd_rn(acc2[b][2], spill[(16 + b * 3 + 2) * 128 + tt]);
        }
    }
}

// dW1 (32, 64) and dW2 (64, 17) from N's partials: column e summed over the
// partials p = s, s + kSlices, ... by slice s, then the slices in order
__global__ void __launch_bounds__(32 * kSlices) geo_chain_reduce_kernel(const float* __restrict__ parts, int n_parts,
                                                                        float* __restrict__ dw1,
                                                                        float* __restrict__ dw2) {
    __shared__ float sums[kSlices][32];
    const int e = blockIdx.x * 32 + (threadIdx.x & 31), s = threadIdx.x >> 5;
    float acc = 0.f;
    if (e < kPartSize)
        for (int p = s; p < n_parts; p += kSlices) acc = __fadd_rn(acc, parts[static_cast<int64_t>(p) * kPartSize + e]);
    sums[s][threadIdx.x & 31] = acc;
    __syncthreads();
    if (s == 0 && e < kPartSize) {
        float total = sums[0][threadIdx.x];
#pragma unroll
        for (int k = 1; k < kSlices; ++k) total = __fadd_rn(total, sums[k][threadIdx.x]);
        if (e < kIn * kHid) {
            dw1[e] = total;
        } else {
            dw2[e - kIn * kHid] = total;
        }
    }
}

int64_t n_parts_for(int64_t n_rows) {
    const int64_t tiles = (n_rows + kTile - 1) / kTile;
    return tiles < kParts ? (tiles > 0 ? tiles : 1) : kParts;
}

}  // namespace

// N's partial sums for n_rows rows: (the launcher's parts) rows of
// arcnerf_geo_chain_part_size() floats.
extern "C" long long arcnerf_geo_chain_bwd_parts(long long n_rows) { return n_parts_for(n_rows); }

extern "C" long long arcnerf_geo_chain_part_size() { return kPartSize; }

// enc (n_rows, 32) f32, 16-byte aligned; n_valid: an int64 on the device
// (the rows to compute; the rest come out 0) or null (every row); w1 (32,
// 64), w2 (64, 17) f32; out (n_rows, 17), g (n_rows, 32) f32 (16-byte
// aligned).
extern "C" int arcnerf_geo_chain_fwd(const void* enc, long long n_rows, const void* n_valid, const void* w1,
                                     const void* w2, float beta, void* out, void* g, void* stream) {
    if (n_rows <= 0 || !(beta > 0.f)) return ARCNERF_BAD_ARGUMENT;
    const int64_t tiles = (n_rows + kTile - 1) / kTile;
    const size_t smem = sizeof(FwdShared);
    const cudaError_t err = cudaFuncSetAttribute(geo_chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    geo_chain_fwd_kernel<<<static_cast<unsigned int>(tiles < kFwdGrid ? tiles : kFwdGrid), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(enc), n_rows, static_cast<const int64_t*>(n_valid), static_cast<const float*>(w1),
        static_cast<const float*>(w2), beta, 1.f / beta, static_cast<float*>(out), static_cast<float*>(g));
    return static_cast<int>(cudaGetLastError());
}

// The same inputs and d_out (n_rows, 17), d_g (n_rows, 32) f32 (16-byte
// aligned) -> d_enc (n_rows, 32), dw1 (32, 64), dw2 (64, 17) f32; parts:
// arcnerf_geo_chain_bwd_parts(n_rows) x arcnerf_geo_chain_part_size() f32
// of scratch. Launches N, then the reduce.
extern "C" int arcnerf_geo_chain_bwd(const void* enc, long long n_rows, const void* n_valid, const void* w1,
                                     const void* w2, const void* d_out, const void* d_g, float beta, void* d_enc,
                                     void* dw1, void* dw2, void* parts, void* stream) {
    if (n_rows <= 0 || !(beta > 0.f)) return ARCNERF_BAD_ARGUMENT;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_parts = static_cast<int>(n_parts_for(n_rows));
    const size_t smem = sizeof(BwdShared);
    cudaError_t err = cudaFuncSetAttribute(geo_chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    geo_chain_bwd_kernel<<<n_parts, kThreads, smem, s>>>(
        static_cast<const float*>(enc), n_rows, static_cast<const int64_t*>(n_valid), static_cast<const float*>(w1),
        static_cast<const float*>(w2), static_cast<const float*>(d_out), static_cast<const float*>(d_g), beta,
        1.f / beta, static_cast<float*>(d_enc), static_cast<float*>(parts));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    geo_chain_reduce_kernel<<<(kPartSize + 31) / 32, 32 * kSlices, 0, s>>>(
        static_cast<const float*>(parts), n_parts, static_cast<float*>(dw1), static_cast<float*>(dw2));
    return static_cast<int>(cudaGetLastError());
}
