// The kernels' C launchers (kernels A-L, the sampler), declared once for
// the kernels that define them and for the Python binding that calls them
// (bindings.cpp): a launcher whose definition drifts from this
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
// C, segment_march.cu (mode: 0 / 1 sigma without / with add_inf_z, 2 alpha)
int arcnerf_segment_march_fwd(const void* sigma, const void* rgb, const void* z, const void* off, const void* cnt,
                              int n_rays, long long k_total, int mode, const void* bkg, int white_bkg, int group,
                              void* out_rgb, void* out_depth, void* out_mask, void* out_trans_end, void* stream);
// F, segment_march_bwd.cu (mode as C's)
int arcnerf_segment_march_bwd(const void* sigma, const void* rgb, const void* z, const void* off, const void* cnt,
                              int n_rays, long long k_total, int mode, const void* bkg, int white_bkg,
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
// the sampler and its compaction, sample_compact.cu: count + scan, then write
// (sections: an SDF's sections in place of the samples; len non-null writes their lengths)
int arcnerf_sample_count(const void* rays_o, const void* rays_d, int n_rays, const void* bitfield, int n_grid,
                         const float* box, const float* inv_voxel, const void* rand, int n_pts, float fix_t, int cap,
                         long long budget, int sections, void* tot, void* near_far, void* clamp, void* first_z,
                         void* ray_has, void* off, void* cnt, void* n_valid, void* stream);
int arcnerf_sample_write(const void* rays_o, const void* rays_d, int n_rays, const void* bitfield, int n_grid,
                         const float* box, const float* inv_voxel, const void* rand, int n_pts, float fix_t,
                         const void* near_far, const void* clamp, const void* first_z, const void* off, const void* cnt,
                         const void* n_valid, long long budget, int cap, void* z, void* pts, void* dirs, void* len,
                         void* stream);
// K and L, hash_dx.cu: the hash grid's input gradient and its backward
int arcnerf_hash_dx(const void* xyz, long long n_pts, const void* table, const void* g, int n_levels, int log2_table,
                    int n_feat, const void* res, const float* aabb_min, const float* aabb_len, int variant,
                    int read_bf16, void* dx, void* stream);
int arcnerf_hash_dx_bwd(const void* xyz, long long n_pts, const void* table, const void* g, const void* g_dx,
                        int n_levels, int log2_table, int n_feat, const void* res, const float* aabb_min,
                        const float* aabb_len, int variant, int read_bf16, void* d_table, void* d_g, void* stream);

}  // extern "C"
