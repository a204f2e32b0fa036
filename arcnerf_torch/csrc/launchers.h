// The kernels' C launchers (kernels A-J), one per .cu file, declared once
// for the kernels that define them and for the Python binding that calls
// them (bindings.cpp): a launcher whose definition drifts from this
// declaration does not compile. Plain C++, no CUDA types.
//
// Every launcher takes device pointers and PyTorch's stream, launches on
// that stream without synchronising, and returns 0, the cudaError_t of
// cudaGetLastError() right after the launch, or ARCNERF_BAD_ARGUMENT for an
// argument the kernel does not take (checked before any launch).
#pragma once

#define ARCNERF_BAD_ARGUMENT 100000

extern "C" {

// A, fused_mlp.cu
int arcnerf_fused_mlp_fwd(const void* x, int n_rows, int d_in, int din_pad, const void* weights, int width,
                          int n_hidden, int d_out, int dout_pad, void* out, void* pre, void* stream);
// D, fused_mlp_bwd.cu
int arcnerf_fused_mlp_bwd(const void* x, const void* g, int n_rows, int d_in, int din_pad, const void* weights,
                          int width, int n_hidden, int d_out, int dout_pad, const void* pre, void* dx, void* dw,
                          void* stream);
// B, hash_encode.cu
int arcnerf_hash_encode_fwd(const void* xyz, long long n_pts, const void* table, int n_levels, int log2_table,
                            int n_feat, const void* res, const float* aabb_min, const float* aabb_len, int variant,
                            int read_bf16, void* out, void* stream);
// E, hash_encode_bwd.cu
int arcnerf_hash_encode_bwd(const void* xyz, long long n_pts, const void* g, int n_levels, int log2_table, int n_feat,
                            const void* res, const float* aabb_min, const float* aabb_len, int variant, void* grad,
                            void* stream);
// C, segment_march.cu
int arcnerf_segment_march_fwd(const void* sigma, const void* rgb, const void* z, const void* off, const void* cnt,
                              int n_rays, long long k_total, int add_inf_z, const void* bkg, int white_bkg, int group,
                              void* out_rgb, void* out_depth, void* out_mask, void* out_trans_end, void* stream);
// F, segment_march_bwd.cu
int arcnerf_segment_march_bwd(const void* sigma, const void* rgb, const void* z, const void* off, const void* cnt,
                              int n_rays, long long k_total, int add_inf_z, const void* bkg, int white_bkg,
                              const void* g_rgb, const void* g_depth, const void* g_mask, void* d_sigma, void* d_rgb,
                              void* stream);
// G, row_gather.cu
int arcnerf_row_gather(const void* table, long long n_table, int row_bytes, const void* idx, long long n_rows,
                       void* out, void* stream);
// H, lane_gather.cu
int arcnerf_lane_gather(const void* src, long long m, long long w_src, const void* idx, long long idx_stride,
                        long long n, void* out, void* stream);
// I, scatter_add_rows.cu
int arcnerf_scatter_add_rows(void* out, long long n_table, int w, const void* idx, const void* g, long long n,
                             void* scratch, long long scratch_bytes, void* stream);
long long arcnerf_scatter_add_rows_scratch_bytes(long long n_table, int w, long long n);
// J, update_rows.cu
int arcnerf_build_update_rows(const void* lane0, const void* vals, long long k, const int* offs, int n_off, int n_feat,
                              void* out, void* stream);

}  // extern "C"
