// Kernel D: fused bias-free MLP backward from the saved pre-activations, on
// the H100's bf16 tensor cores (mma.sync.m16n8k16, f32 accumulation).
//
// Replaces the Pallas backward of arcnerf_tpu/ops/fused_mlp.py:172
// (_fused_mlp_bwd, body _bwd_kernel :63). Inputs: x (B, D_in) f32, the output
// gradient g (B, D_out) f32, the chain's bf16 weights (the packed buffer of
// kernel A) and kernel A's saved bf16 hidden pre-activations. Outputs: dX
// (B, D_in) f32, and every layer's dW in f32 summed over all rows. The
// rounding is the Pallas kernel's: a layer's input P is bf16(x) or
// relu(pre), g stays f32 through the ReLU mask (pre > 0) and into
// dW = P^T g, and g is rounded to bf16 only for the dX product g W^T.
//
// What bounds it on the H100: at 2^18 rows it moves x, g, the bf16
// pre-activations and dX once: 412 B a row for the radiance chain
// (18->64->64->3), 108.0 MB, and 448 B a row for geo (32->64->16),
// 117.4 MB, so 0.067 ms together at 3.35 TB/s. Its 5.7 + 3.2 GFLOP take
// 9 us at the bf16 tensor-core peak: HBM-bound.
//
// Design. Persistent CTAs of 4 warps (as many as fit, 3 an SM for the NGP
// chains) loop over 64-row tiles; warp w owns the tile's rows 16w..16w+15.
// The weights sit in shared memory once per CTA. Walking the chain from the
// output layer down, per layer:
// - dW = P^T g over the tile's 64 rows on tensor cores (mma.sync.m16n8k16
//   bf16, f32 accumulation): each warp stages its rows' input P (bf16) and g
//   in shared memory (rows padded to 72 bf16, so ldmatrix reads them without
//   bank conflicts), then owns a share of dW's m16n8 tiles and reads both
//   operands with ldmatrix.trans. g is f32, and bf16(g) alone would put a
//   2^-9 relative error on every term, which 2^18 rows sum past the 1e-4
//   tolerance; so g goes in as g_hi = bf16(g) and g_lo = bf16(g - g_hi), two
//   MMAs into one f32 accumulator, ~2^-17 a term
//   (tests/test_torch_mlp_bwd_numerics.py). The accumulators stay in
//   registers across all of the CTA's tiles.
// - dX = bf16(g) W^T. Every product but the first layer's is rounded to bf16
//   again as the next layer's g, and a sum taken in another order flips a
//   bf16 rounding now and then; one flip of a g near 1 moves dX by ~1e-3 of
//   its largest value, and 2^18 rows hold hundreds of them (6e-4 off from a
//   change of summation order alone, tests/test_torch_mlp_bwd_numerics.py).
//   So those products keep the plain version's order, sequential f32 FMAs
//   over the output columns on the FP32 pipes (f32 transposed weights in
//   shared memory, broadcast float4 reads, 4 rows x 8 columns a thread):
//   for radiance 2^18 x 4096 FMAs, 36 us at the FP32 peak, the floor of this
//   design. The first layer's product, which ends in dX itself, runs on
//   tensor cores (A from the staged bf16(g) by ldmatrix).
// - Inputs arrive by cp.async into a second P buffer (and x into its own)
//   one phase or more ahead of use; the ReLU is applied where P is read.
// - At the end each CTA writes its dW partial to its row of the scratch
//   buffer, and a second kernel sums the rows in a fixed order into row 0:
//   dW is the same from run to run, with no atomics.
// The register accumulators cap the chain at kMaxHidden hidden layers (the
// nets of configs/ have 1 or 2).

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // rows per tile
constexpr int kW = 64;              // chain width
constexpr int kOut = 16;            // D_out padded for dW's MMAs
constexpr int kStride = kW + 8;     // bf16 elements per shared-memory row: 144 B, conflict-free ldmatrix
constexpr int kWtStride = kW + 4;   // floats per row of the transposed f32 weights: 4-way stores, not 32-way
constexpr int kMaxHidden = 3;
constexpr int kMaxParts = 1024;     // scratch rows; fused_mlp.py sizes dW by it

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// d += a b for one m16n8k16 tile: a the A fragment (4 regs), b0/b1 the B fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                 "{%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t relu2(uint32_t v) {
    __nv_bfloat162 h = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&v), __float2bfloat162_rn(0.f));
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// Wait for this thread's cp.async copies; other threads see them after a barrier.
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A thread's share of the warp's 16 x 64 g: rows rg + 4 i (rg = lane / 8,
// i < 4) at columns 4 kg + 32 m + c (kg = lane % 8, m < 2, c < 4), held as
// g[2 i + m][c]. These helpers give the element's row and first column.
__device__ __forceinline__ int g_row(int lane, int q) { return (lane >> 3) + 4 * (q >> 1); }
__device__ __forceinline__ int g_col(int lane, int q) { return 4 * (lane & 7) + 32 * (q & 1); }

// Stages g_hi = bf16(g) and g_lo = bf16(g - g_hi) of a thread's share at the
// warp's rows (from ghi / glo, which point at the warp's first row).
__device__ __forceinline__ void stage_g(const float (&g)[8][4], __nv_bfloat16* ghi, __nv_bfloat16* glo, int lane) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const uint2 hi = make_uint2(pack_bf16(g[q][0], g[q][1]), pack_bf16(g[q][2], g[q][3]));
        const float2 b0 = unpack_bf16(hi.x), b1 = unpack_bf16(hi.y);
        const uint2 lo = make_uint2(pack_bf16(g[q][0] - b0.x, g[q][1] - b0.y), pack_bf16(g[q][2] - b1.x,
                                                                                        g[q][3] - b1.y));
        const int off = g_row(lane, q) * kStride + g_col(lane, q);
        *reinterpret_cast<uint2*>(ghi + off) = hi;
        *reinterpret_cast<uint2*>(glo + off) = lo;
    }
}

// Start copying the warp's 16 rows of a hidden layer's pre-activations into
// P (16-byte cp.async; rows past n_rows are zero). The ReLU is applied where
// P is read.
__device__ __forceinline__ void load_pre(const __nv_bfloat16* __restrict__ pre, int64_t row0, int n_valid,
                                         __nv_bfloat16* p, int warp, int lane) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int c = lane + 32 * q, r = c >> 3, part = c & 7;
        __nv_bfloat16* dst = p + (16 * warp + r) * kStride + 8 * part;
        if (r < n_valid) {
            cp_async16(dst, pre + (row0 + r) * kW + 8 * part);
        } else {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
    }
}

// Start copying the warp's rows of x into xs (the warp's 16 DIN floats,
// filled as one run of n_valid d_in floats: 72-byte rows at d_in = 18). The
// run starts 16-byte aligned (row0 is a multiple of 16), so 16-byte copies
// where its length allows, then 4-byte ones.
template <int DIN>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int64_t row0, int n_valid, int d_in, float* xs,
                                       int warp, int lane) {
    const int n = (n_valid > 0 ? n_valid : 0) * d_in, n4 = n & ~3;
    const float* src = x + row0 * d_in;
    float* dst = xs + 16 * warp * DIN;
    for (int e = 4 * lane; e < n4; e += 128) cp_async16(dst + e, src + e);
    for (int e = n4 + lane; e < n; e += 32) cp_async4(dst + e, src + e);
}

// The first layer's input, bf16(x) zero-padded to DIN, for the warp's rows:
// xs (after the copies of load_x) -> P.
template <int DIN>
__device__ __forceinline__ void stage_x(const float* xs, int n_valid, int d_in, __nv_bfloat16* p, int warp,
                                        int lane) {
    __syncwarp();
    const float* src = xs + 16 * warp * DIN;
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int c = lane; c < DIN; c += 32)
            p[(16 * warp + r) * kStride + c] =
                    __float2bfloat16_rn((r < n_valid && c < d_in) ? src[r * d_in + c] : 0.f);
}

// The warp's 16 rows of the output gradient into registers: the thread's
// row (lane / 2) at columns 8 h .. 8 h + 7, zero past d_out.
__device__ __forceinline__ void load_gout(const float* __restrict__ gout, int64_t row0, int n_valid, int d_out,
                                          int lane, float (&gf)[8]) {
    const int r = lane >> 1, h = lane & 1;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int c = 8 * h + e;
        gf[e] = (r < n_valid && c < d_out) ? gout[(row0 + r) * d_out + c] : 0.f;
    }
}

// acc += P^T (g_hi + g_lo) over the tile's 64 staged rows, for the warp's
// share of a (16 MT) x (8 NT) dW: with MT = 4 one m-tile and all NT
// n-tiles, with MT = 2 one m-tile and half of the n-tiles. RELU: P holds
// pre-activations, and the layer's input is relu(P).
template <int MT, int NT, bool RELU>
__device__ __forceinline__ void dw_step(float (&acc)[MT * NT / kWarps][4], const __nv_bfloat16* p,
                                        const __nv_bfloat16* ghi, const __nv_bfloat16* glo, int warp, int lane) {
    static_assert(MT == 2 || MT == 4, "dW m-tiles");
    constexpr int NW = MT * NT / kWarps;
    const int mt = MT == 4 ? warp : (warp & 1);
    const int nt0 = MT == 4 ? 0 : (warp >> 1) * NW;
    const int q = lane >> 3, r = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < kTile; k0 += 16) {
        // A = P^T: 8x8 blocks (rows k0 + {0, 8}, columns 16 mt + {0, 8})
        uint32_t a[4];
        ldsm_x4_trans(a, p + (k0 + r + (q >> 1) * 8) * kStride + 16 * mt + (q & 1) * 8);
        if (RELU) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = relu2(a[i]);
        }
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
            const int off = (k0 + r + (q & 1) * 8) * kStride + 8 * (nt0 + j) + (q >> 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4_trans(bh, ghi + off);
            ldsm_x4_trans(bl, glo + off);
            mma_bf16(acc[j], a, bh[0], bh[1]);
            mma_bf16(acc[j], a, bl[0], bl[1]);
            mma_bf16(acc[j + 1], a, bh[2], bh[3]);
            mma_bf16(acc[j + 1], a, bl[2], bl[3]);
        }
    }
}

// The first layer's dX for the warp's 16 rows: out (16 x K, m16n8 C
// fragments) = bf16(g) (16 x 64, staged in Ghi) W_0^T, W_0 (K x 64) bf16.
template <int K>
__device__ __forceinline__ void dx_mma(const __nv_bfloat16* ghi, const __nv_bfloat16* w, float (&out)[K / 8][4],
                                       int lane) {
    const int q = lane >> 3, r = lane & 7;
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kW / 16; ++kb) {
        uint32_t a[4];
        ldsm_x4(a, ghi + ((q & 1) * 8 + r) * kStride + 16 * kb + (q >> 1) * 8);
#pragma unroll
        for (int j = 0; j < K / 8; j += 2) {
            uint32_t b[4];
            ldsm_x4(b, w + (8 * j + r + (q >> 1) * 8) * kStride + 16 * kb + (q & 1) * 8);
            mma_bf16(out[j], a, b[0], b[1]);
            mma_bf16(out[j + 1], a, b[2], b[3]);
        }
    }
}

// A layer's dX in the plain version's order: o = sum over j < n_j, in
// order, of bf16(g)[r][j] * W[k][j] by f32 FMAs from 0, for a thread's share
// of rows r and columns k (see g_row). ghi: the staged bf16(g) from the
// warp's first row; wt: the layer's weights transposed, f32 (n_j rows of
// kWtStride).
__device__ __forceinline__ void dx_fma(const __nv_bfloat16* ghi, const float* wt, int n_j, int lane,
                                       float (&o)[8][4]) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[q][c] = 0.f;
    const float* wk = wt + 4 * (lane & 7);
#pragma unroll 1
    for (int j0 = 0; j0 < n_j; j0 += 8) {
        uint4 gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = *reinterpret_cast<const uint4*>(ghi + g_row(lane, 2 * i) * kStride + j0);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            if (j0 + jj >= n_j) break;
            const float4 w0 = *reinterpret_cast<const float4*>(wk + (j0 + jj) * kWtStride);
            const float4 w1 = *reinterpret_cast<const float4*>(wk + (j0 + jj) * kWtStride + 32);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint32_t word = (&gv[i].x)[jj >> 1];
                const float gj = __uint_as_float((jj & 1) ? (word & 0xffff0000u) : (word << 16));
                o[2 * i][0] = fmaf(gj, w0.x, o[2 * i][0]);
                o[2 * i][1] = fmaf(gj, w0.y, o[2 * i][1]);
                o[2 * i][2] = fmaf(gj, w0.z, o[2 * i][2]);
                o[2 * i][3] = fmaf(gj, w0.w, o[2 * i][3]);
                o[2 * i + 1][0] = fmaf(gj, w1.x, o[2 * i + 1][0]);
                o[2 * i + 1][1] = fmaf(gj, w1.y, o[2 * i + 1][1]);
                o[2 * i + 1][2] = fmaf(gj, w1.z, o[2 * i + 1][2]);
                o[2 * i + 1][3] = fmaf(gj, w1.w, o[2 * i + 1][3]);
            }
        }
    }
}

// g *= (pre > 0) for a thread's share, pre from P (the warp's first row).
__device__ __forceinline__ void relu_mask(float (&g)[8][4], const __nv_bfloat16* p, int lane) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const uint2 v = *reinterpret_cast<const uint2*>(p + g_row(lane, q) * kStride + g_col(lane, q));
        const float2 a = unpack_bf16(v.x), b = unpack_bf16(v.y);
        g[q][0] = a.x > 0.f ? g[q][0] : 0.f;
        g[q][1] = a.y > 0.f ? g[q][1] : 0.f;
        g[q][2] = b.x > 0.f ? g[q][2] : 0.f;
        g[q][3] = b.y > 0.f ? g[q][3] : 0.f;
    }
}

// One layer's dW partial (the warp's tiles) -> part at the packed layout
// (rows x n_cols, columns past n_cols dropped).
template <int MT, int NT>
__device__ __forceinline__ void store_dw(const float (&acc)[MT * NT / kWarps][4], float* __restrict__ part,
                                         int n_cols, int warp, int lane) {
    constexpr int NW = MT * NT / kWarps;
    const int mt = MT == 4 ? warp : (warp & 1);
    const int nt0 = MT == 4 ? 0 : (warp >> 1) * NW;
    const int r = 16 * mt + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = r + 8 * (e >> 1), col = 8 * (nt0 + j) + c + (e & 1);
            if (col < n_cols) part[row * n_cols + col] = acc[j][e];
        }
}

template <int DIN, int NHH>
__global__ void __launch_bounds__(kThreads, 3) fused_mlp_bwd_kernel(
        const float* __restrict__ x, const float* __restrict__ gout, int n_rows, int d_in, int d_out, int dout_pad,
        const __nv_bfloat16* __restrict__ weights, const __nv_bfloat16* __restrict__ pre, int n_hidden,
        float* __restrict__ dx, float* __restrict__ parts) {
    extern __shared__ uint4 smem4[];
    // f32 transposed weights of the hidden layers (64 x 64 each) and of the
    // output layer (kOut x 64, rows past dout_pad zero); x (16 DIN floats a
    // warp); W_0 bf16 (DIN rows); then two P buffers, Ghi and Glo (64 rows each)
    float* wt = reinterpret_cast<float*>(smem4);
    float* wt_out = wt + NHH * kW * kWtStride;
    float* xs = wt_out + kOut * kWtStride;
    __nv_bfloat16* w0 = reinterpret_cast<__nv_bfloat16*>(xs + kTile * DIN);
    __nv_bfloat16* pbuf = w0 + DIN * kStride;
    __nv_bfloat16* ghi = pbuf + 2 * kTile * kStride;
    __nv_bfloat16* glo = ghi + kTile * kStride;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rw = lane >> 1, h = lane & 1;  // the row of the warp's 16 and the column half of gout's staging
    __nv_bfloat16* ghi_w = ghi + 16 * warp * kStride;  // the warp's rows
    __nv_bfloat16* glo_w = glo + 16 * warp * kStride;
    auto p_of = [&](int buf) { return pbuf + buf * kTile * kStride; };

    for (int e = threadIdx.x; e < DIN * kW; e += kThreads) w0[(e / kW) * kStride + e % kW] = weights[e];
    // wt[l][j][k] = W_l[k][j] (packed after W_0), read in the packed order
    for (int e = threadIdx.x; e < NHH * kW * kW; e += kThreads) {
        const int l = e / (kW * kW), k = (e / kW) % kW, j = e % kW;
        wt[(l * kW + j) * kWtStride + k] = __bfloat162float(weights[DIN * kW + e]);
    }
    for (int e = threadIdx.x; e < kOut * kW; e += kThreads) {
        const int k = e / kOut, j = e % kOut;
        const int src = (DIN + NHH * kW) * kW + k * dout_pad + j;
        wt_out[j * kWtStride + k] = j < dout_pad ? __bfloat162float(weights[src]) : 0.f;
    }

    float acc0[DIN / 8][4], acch[NHH > 0 ? NHH : 1][8][4], acco[2][4];
#pragma unroll
    for (int j = 0; j < DIN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc0[j][e] = 0.f;
#pragma unroll
    for (int l = 0; l < (NHH > 0 ? NHH : 1); ++l)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acch[l][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acco[j][e] = 0.f;

    // Each layer of a tile is one phase: stage g, barrier, start copying an
    // input still to come into a free buffer, dW and dX, barrier. A hidden
    // phase's P is copied in during the phase before it; the next tile's
    // pre[n_hidden - 1] during the phase before the first layer, whose bf16(x)
    // then reuses the P buffer just read; the next tile's x and gout during
    // the first layer, right after x was staged.
    const int n_tiles = (n_rows + kTile - 1) / kTile;
    const __nv_bfloat16* pre_last = pre + static_cast<int64_t>(n_hidden - 1) * n_rows * kW;
    auto rows = [&](int tile, int64_t& row0, int& n_valid) {
        row0 = static_cast<int64_t>(tile) * kTile + 16 * warp;
        const int64_t left = n_rows - row0;
        n_valid = left < 16 ? static_cast<int>(left) : 16;  // may be <= 0
    };
    int cur = 0;  // the P buffer of the current phase
    float gf[8];
    if (static_cast<int>(blockIdx.x) < n_tiles) {
        int64_t row0;
        int n_valid;
        rows(blockIdx.x, row0, n_valid);
        load_pre(pre_last, row0, n_valid, p_of(0), warp, lane);
        load_x<DIN>(x, row0, n_valid, d_in, xs, warp, lane);
        load_gout(gout, row0, n_valid, d_out, lane, gf);
    }
    auto load_next_last = [&](int tile, int buf) {
        if (tile + static_cast<int>(gridDim.x) >= n_tiles) return;
        int64_t next0;
        int next_valid;
        rows(tile + gridDim.x, next0, next_valid);
        load_pre(pre_last, next0, next_valid, p_of(buf), warp, lane);
    };
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int64_t row0;
        int n_valid;
        rows(tile, row0, n_valid);
        float g[8][4];

        // output layer: g = gout (the thread's 8 of kOut columns), input relu(pre[n_hidden - 1])
        {
            const uint2 hi0 = make_uint2(pack_bf16(gf[0], gf[1]), pack_bf16(gf[2], gf[3]));
            const uint2 hi1 = make_uint2(pack_bf16(gf[4], gf[5]), pack_bf16(gf[6], gf[7]));
            const float2 a0 = unpack_bf16(hi0.x), a1 = unpack_bf16(hi0.y), a2 = unpack_bf16(hi1.x),
                         a3 = unpack_bf16(hi1.y);
            const uint4 lo = make_uint4(pack_bf16(gf[0] - a0.x, gf[1] - a0.y), pack_bf16(gf[2] - a1.x, gf[3] - a1.y),
                                        pack_bf16(gf[4] - a2.x, gf[5] - a2.y), pack_bf16(gf[6] - a3.x, gf[7] - a3.y));
            *reinterpret_cast<uint4*>(ghi_w + rw * kStride + 8 * h) = make_uint4(hi0.x, hi0.y, hi1.x, hi1.y);
            *reinterpret_cast<uint4*>(glo_w + rw * kStride + 8 * h) = lo;
        }
        cp_async_wait();
        __syncthreads();
        if (NHH > 0) {
            load_pre(pre + static_cast<int64_t>(NHH - 1) * n_rows * kW, row0, n_valid, p_of(cur ^ 1), warp, lane);
        } else {
            load_next_last(tile, cur ^ 1);
        }
        dw_step<4, 2, true>(acco, p_of(cur), ghi, glo, warp, lane);
        dx_fma(ghi_w, wt_out, d_out, lane, g);
        relu_mask(g, p_of(cur) + 16 * warp * kStride, lane);
        __syncthreads();
        if (NHH > 0) cur ^= 1;

        // hidden layers, last to second: input relu(pre[l - 1])
#pragma unroll
        for (int l = NHH; l >= 1; --l) {
            stage_g(g, ghi_w, glo_w, lane);
            cp_async_wait();
            __syncthreads();
            if (l >= 2) {
                load_pre(pre + static_cast<int64_t>(l - 2) * n_rows * kW, row0, n_valid, p_of(cur ^ 1), warp, lane);
            } else {
                load_next_last(tile, cur ^ 1);
            }
            dw_step<4, 8, true>(acch[l - 1], p_of(cur), ghi, glo, warp, lane);
            dx_fma(ghi_w, wt + (l - 1) * kW * kWtStride, kW, lane, g);
            relu_mask(g, p_of(cur) + 16 * warp * kStride, lane);
            __syncthreads();
            if (l >= 2) cur ^= 1;
        }

        // first layer: input bf16(x), in the P buffer of the phase before; dX on tensor cores
        cp_async_wait();
        stage_x<DIN>(xs, n_valid, d_in, p_of(cur), warp, lane);
        stage_g(g, ghi_w, glo_w, lane);
        __syncthreads();
        if (tile + static_cast<int>(gridDim.x) < n_tiles) {
            int64_t next0;
            int next_valid;
            rows(tile + gridDim.x, next0, next_valid);
            load_x<DIN>(x, next0, next_valid, d_in, xs, warp, lane);
            load_gout(gout, next0, next_valid, d_out, lane, gf);
        }
        dw_step<DIN / 16, 8, false>(acc0, p_of(cur), ghi, glo, warp, lane);
        float o[DIN / 8][4];
        dx_mma<DIN>(ghi_w, w0, o, lane);
        const bool pairs = (d_in & 1) == 0;  // 8-byte aligned float2 stores
#pragma unroll
        for (int j = 0; j < DIN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int r = (lane >> 2) + 8 * e, c = 8 * j + 2 * (lane & 3);
                if (r >= n_valid || c >= d_in) continue;
                float* dst = dx + (row0 + r) * d_in + c;
                if (pairs) {
                    *reinterpret_cast<float2*>(dst) = make_float2(o[j][2 * e], o[j][2 * e + 1]);
                } else {
                    dst[0] = o[j][2 * e];
                    if (c + 1 < d_in) dst[1] = o[j][2 * e + 1];
                }
            }
        __syncthreads();
        cur ^= 1;
    }

    float* part = parts + static_cast<int64_t>(blockIdx.x) * ((DIN + NHH * kW) * kW + kW * dout_pad);
    store_dw<DIN / 16, 8>(acc0, part, kW, warp, lane);
#pragma unroll
    for (int l = 0; l < NHH; ++l) store_dw<4, 8>(acch[l], part + (DIN + l * kW) * kW, kW, warp, lane);
    store_dw<4, 2>(acco, part + (DIN + NHH * kW) * kW, dout_pad, warp, lane);
}

// parts[0][e] = sum over the n_parts rows of parts[r][e], in a fixed order:
// 8 slices of rows per element, then the slices in order. In place: a column
// is read and written by one block only, and written after the block read it.
constexpr int kSlices = 8;

__global__ void __launch_bounds__(32 * kSlices) reduce_parts_kernel(float* __restrict__ parts, int n_parts, int n_w) {
    __shared__ float sums[kSlices][32];
    const int e = blockIdx.x * 32 + (threadIdx.x & 31), s = threadIdx.x >> 5;
    float acc = 0.f;
    if (e < n_w)
        for (int r = s; r < n_parts; r += kSlices) acc += parts[static_cast<int64_t>(r) * n_w + e];
    sums[s][threadIdx.x & 31] = acc;
    __syncthreads();
    if (s == 0 && e < n_w) {
        float total = sums[0][threadIdx.x];
#pragma unroll
        for (int k = 1; k < kSlices; ++k) total += sums[k][threadIdx.x];
        parts[e] = total;
    }
}

template <int DIN, int NHH>
int launch(const float* x, const float* g, int n_rows, int d_in, int d_out, int dout_pad,
           const __nv_bfloat16* weights, const __nv_bfloat16* pre, int n_hidden, float* dx, float* dw,
           cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((NHH * kW + kOut) * kWtStride + kTile * DIN) +
                        sizeof(__nv_bfloat16) * kStride * (DIN + 4 * kTile);
    auto kernel = fused_mlp_bwd_kernel<DIN, NHH>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    int device = 0, n_sm = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n_rows + kTile - 1) / kTile;
    int grid = per_sm * n_sm;
    if (grid > kMaxParts) grid = kMaxParts;
    if (grid > n_tiles) grid = n_tiles;
    if (grid < 1) grid = 1;
    kernel<<<grid, kThreads, smem, stream>>>(x, g, n_rows, d_in, d_out, dout_pad, weights, pre, n_hidden, dx, dw);
    err = cudaGetLastError();
    if (err != cudaSuccess || grid == 1) return static_cast<int>(err);
    const int n_w = (DIN + NHH * kW) * kW + kW * dout_pad;
    reduce_parts_kernel<<<(n_w + 31) / 32, 32 * kSlices, 0, stream>>>(dw, grid, n_w);
    return static_cast<int>(cudaGetLastError());
}

template <int DIN>
int launch_hidden(int n_hidden, const float* x, const float* g, int n_rows, int d_in, int d_out, int dout_pad,
                  const __nv_bfloat16* weights, const __nv_bfloat16* pre, float* dx, float* dw,
                  cudaStream_t stream) {
    switch (n_hidden) {
        case 1: return launch<DIN, 0>(x, g, n_rows, d_in, d_out, dout_pad, weights, pre, n_hidden, dx, dw, stream);
        case 2: return launch<DIN, 1>(x, g, n_rows, d_in, d_out, dout_pad, weights, pre, n_hidden, dx, dw, stream);
        case 3: return launch<DIN, 2>(x, g, n_rows, d_in, d_out, dout_pad, weights, pre, n_hidden, dx, dw, stream);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}

}  // namespace

// x (n_rows, d_in) f32; g (n_rows, d_out) f32; weights packed as for
// arcnerf_fused_mlp_fwd (DIN = din_pad, DOUT = dout_pad); pre (n_hidden,
// n_rows, width) bf16 from the forward; dx (n_rows, d_in) f32. dw is f32
// scratch of min(ceil(n_rows / 64), 1024) rows of the packed layout, written,
// not accumulated into: row 0 receives dW. 1 <= n_hidden <= 3.
extern "C" int arcnerf_fused_mlp_bwd(const void* x, const void* g, int n_rows, int d_in, int din_pad,
                                     const void* weights, int width, int n_hidden, int d_out, int dout_pad,
                                     const void* pre, void* dx, void* dw, void* stream) {
    if (n_rows <= 0 || n_hidden < 1 || n_hidden > kMaxHidden || width != kW || d_in > din_pad ||
        d_out > dout_pad || (dout_pad != 4 && dout_pad != kOut))
        return ARCNERF_BAD_ARGUMENT;
    const float* xp = static_cast<const float*>(x);
    const float* gp = static_cast<const float*>(g);
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(weights);
    const __nv_bfloat16* pp = static_cast<const __nv_bfloat16*>(pre);
    float* dxp = static_cast<float*>(dx);
    float* dwp = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (din_pad) {
        case 32: return launch_hidden<32>(n_hidden, xp, gp, n_rows, d_in, d_out, dout_pad, wp, pp, dxp, dwp, s);
        case 64: return launch_hidden<64>(n_hidden, xp, gp, n_rows, d_in, d_out, dout_pad, wp, pp, dxp, dwp, s);
        default: return ARCNERF_BAD_ARGUMENT;
    }
}
