// The Python binding of the kernels' C launchers (kernels A-L, the sampler): one
// function per launcher of launchers.h, called by the wrappers in
// arcnerf_torch (ops/, models/base_modules/encoding.py, render/ray_helper.py).
//
// Each function checks its tensors (CUDA device, type, contiguity, shape,
// 16-byte alignment where the kernel moves 16-byte chunks) and raises
// ValueError, allocates the outputs, launches on PyTorch's current stream
// of the tensors' device, and turns the launcher's status into ValueError
// (ARCNERF_BAD_ARGUMENT) or RuntimeError (a CUDA error). All of it runs in
// C++: the host's work a launch is the one Python call. Outputs come from
// PyTorch's allocator, so a launch can be captured in a CUDA graph.
//
// Light headers only (never torch/extension.h or ATen/ATen.h), so the file
// compiles in seconds and without ninja (ops/cuda_lib.py builds it).
// ARCNERF_MODULE, the module's name, comes from the build: it carries the
// hash of every source.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/csrc/utils/pybind.h>

#include <algorithm>
#include <array>
#include <climits>
#include <cstdint>
#include <optional>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

#include "launchers.h"

namespace {

using at::Tensor;
using c10::ScalarType;

constexpr int kMlpWidth = 64;           // the one width kernels A and D are built for
constexpr int64_t kMlpBwdMaxParts = 1024;  // kMaxParts of fused_mlp_bwd.cu: rows of kernel D's dW partial sums

const char* dtype_name(ScalarType t) {
    switch (t) {
        case ScalarType::Float: return "torch.float32";
        case ScalarType::BFloat16: return "torch.bfloat16";
        case ScalarType::Int: return "torch.int32";
        case ScalarType::Long: return "torch.int64";
        default: return c10::toString(t);
    }
}

// A shape as Python prints a tuple: (8,), (8, 3).
std::string shape_str(at::IntArrayRef sizes) {
    std::ostringstream s;
    s << "(";
    for (size_t i = 0; i < sizes.size(); ++i) s << (i ? ", " : "") << sizes[i];
    s << (sizes.size() == 1 ? ",)" : ")");
    return s.str();
}

// Raises unless t is a contiguous CUDA tensor of dtype on the device of
// `first` (the call's first tensor).
void require(const char* name, const Tensor& t, ScalarType dtype, const Tensor& first) {
    TORCH_CHECK_VALUE(t.is_cuda() && t.scalar_type() == dtype && t.is_contiguous(), name,
                      ": expected contiguous CUDA ", dtype_name(dtype), " tensors, got ", t.device(), " ",
                      dtype_name(t.scalar_type()), " contiguous=", t.is_contiguous() ? "True" : "False");
    TORCH_CHECK_VALUE(t.device() == first.device(), name, ": expected tensors on one device, got ", first.device(),
                      " and ", t.device());
}

void require_index(const char* name, const Tensor& idx, int64_t dims, const Tensor& first) {
    require(name, idx, ScalarType::Int, first);
    TORCH_CHECK_VALUE(idx.dim() == dims, name, ": expected a ", dims, "-D index, got shape ", shape_str(idx.sizes()));
}

void require_numel(const char* name, const Tensor& t, int64_t numel, const char* what) {
    TORCH_CHECK_VALUE(t.numel() == numel, name, ": expected ", numel, " values in ", what, ", got shape ",
                      shape_str(t.sizes()));
}

void require_aligned(const char* name, const Tensor& t) {
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
                      ": the kernel needs 16-byte aligned tensors");
}

void require_int(const char* name, int64_t v, const char* what) {
    TORCH_CHECK_VALUE(v <= INT_MAX, name, ": ", what, " ", v, " does not fit the kernel's 32-bit count");
}

void check_status(const char* name, int status) {
    TORCH_CHECK_VALUE(status != ARCNERF_BAD_ARGUMENT, name, ": the kernel does not take these arguments");
    TORCH_CHECK(status == 0, name, ": CUDA launch failed with cudaError ", status, " (",
                cudaGetErrorString(static_cast<cudaError_t>(status)), ")");
}

void* stream_of(const Tensor& t) {
    return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// ------------------------------------------------------------ A and D

// x (n_rows, d_in) f32, packed: the chain's bf16 buffer (pack_weights) ->
// out (n_rows, d_out) f32 and, with save_pre, pre (n_hidden, n_rows, 64) bf16.
std::tuple<Tensor, std::optional<Tensor>> fused_mlp_fwd(const Tensor& x, const Tensor& packed, int64_t din_pad,
                                                         int64_t n_hidden, int64_t d_out, int64_t dout_pad,
                                                         bool save_pre) {
    const char* name = "fused_mlp";
    require(name, x, ScalarType::Float, x);
    require(name, packed, ScalarType::BFloat16, x);
    TORCH_CHECK_VALUE(x.dim() == 2, name, ": expected a 2-D input, got shape ", shape_str(x.sizes()));
    require_numel(name, packed, din_pad * kMlpWidth + (n_hidden - 1) * kMlpWidth * kMlpWidth + kMlpWidth * dout_pad,
                  "the packed weights");
    const int64_t n_rows = x.size(0);
    require_int(name, n_rows, "rows");
    c10::cuda::CUDAGuard guard(x.device());
    Tensor out = at::empty({n_rows, d_out}, x.options());
    std::optional<Tensor> pre;
    if (save_pre) pre = at::empty({n_hidden, n_rows, kMlpWidth}, x.options().dtype(ScalarType::BFloat16));
    if (n_rows > 0) {
        check_status(name, arcnerf_fused_mlp_fwd(x.data_ptr(), static_cast<int>(n_rows), static_cast<int>(x.size(1)),
                                                 static_cast<int>(din_pad), packed.data_ptr(), kMlpWidth,
                                                 static_cast<int>(n_hidden), static_cast<int>(d_out),
                                                 static_cast<int>(dout_pad), out.data_ptr(),
                                                 pre ? pre->data_ptr() : nullptr, stream_of(x)));
    }
    return {out, pre};
}

// x (n_rows, d_in) f32, g (n_rows, d_out) f32, the packed weights and the
// saved pre-activations -> dx (n_rows, d_in) f32 and the (parts, packed
// size) f32 partial sums whose row 0 ends as the packed dW (zero when there
// are no rows).
std::tuple<Tensor, Tensor> fused_mlp_bwd(const Tensor& x, const Tensor& g, const Tensor& packed, const Tensor& pre,
                                         int64_t din_pad, int64_t n_hidden, int64_t d_out, int64_t dout_pad) {
    const char* name = "fused_mlp_bwd";
    require(name, x, ScalarType::Float, x);
    require(name, g, ScalarType::Float, x);
    require(name, pre, ScalarType::BFloat16, x);
    require(name, packed, ScalarType::BFloat16, x);
    TORCH_CHECK_VALUE(x.dim() == 2, name, ": expected a 2-D input, got shape ", shape_str(x.sizes()));
    const int64_t n_rows = x.size(0);
    require_int(name, n_rows, "rows");
    require_numel(name, g, n_rows * d_out, "g");
    require_numel(name, pre, n_hidden * n_rows * kMlpWidth, "pre");
    require_numel(name, packed, din_pad * kMlpWidth + (n_hidden - 1) * kMlpWidth * kMlpWidth + kMlpWidth * dout_pad,
                  "the packed weights");
    c10::cuda::CUDAGuard guard(x.device());
    Tensor dx = at::empty({n_rows, x.size(1)}, x.options());
    const int64_t n_parts = std::max<int64_t>(1, std::min<int64_t>((n_rows + 63) / 64, kMlpBwdMaxParts));
    if (n_rows == 0) return {dx, at::zeros({n_parts, packed.numel()}, x.options())};
    Tensor parts = at::empty({n_parts, packed.numel()}, x.options());
    check_status(name, arcnerf_fused_mlp_bwd(x.data_ptr(), g.data_ptr(), static_cast<int>(n_rows),
                                             static_cast<int>(x.size(1)), static_cast<int>(din_pad), packed.data_ptr(),
                                             kMlpWidth, static_cast<int>(n_hidden), static_cast<int>(d_out),
                                             static_cast<int>(dout_pad), pre.data_ptr(), dx.data_ptr(),
                                             parts.data_ptr(), stream_of(x)));
    return {dx, parts};
}

// ------------------------------------------------------------ B and E

using Float3 = std::array<float, 3>;

void require_hash_inputs(const char* name, const Tensor& xyz, const Tensor& res, int64_t n_levels) {
    require(name, xyz, ScalarType::Float, xyz);
    require(name, res, ScalarType::Int, xyz);
    TORCH_CHECK_VALUE(xyz.dim() == 2 && xyz.size(1) == 3, name, ": expected (N, 3) points, got shape ",
                      shape_str(xyz.sizes()));
    require_numel(name, res, n_levels, "res");
}

// xyz (N, 3) f32, table (L, T, F) f32 with T = 2^log2_table, res (L,) int32
// -> (N, L F) f32.
Tensor hash_encode_fwd(const Tensor& xyz, const Tensor& table, const Tensor& res, int64_t log2_table,
                       const Float3& aabb_min, const Float3& aabb_len, int64_t variant, bool read_bf16) {
    const char* name = "hash_encode";
    require(name, table, ScalarType::Float, xyz);
    TORCH_CHECK_VALUE(table.dim() == 3 && table.size(1) == (int64_t{1} << log2_table), name,
                      ": expected an (L, 2^", log2_table, ", F) table, got shape ", shape_str(table.sizes()));
    const int64_t n_levels = table.size(0), n_feat = table.size(2);
    require_hash_inputs(name, xyz, res, n_levels);
    // kernel B reads an entry as one vector of n_feat floats
    const int64_t align = std::min<int64_t>(4 * n_feat, 16);
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(table.data_ptr()) % align == 0, name,
                      ": the kernel needs the table aligned to ", align, " bytes");
    c10::cuda::CUDAGuard guard(xyz.device());
    Tensor out = at::empty({xyz.size(0), n_levels * n_feat}, xyz.options());
    if (xyz.size(0) > 0) {
        check_status(name, arcnerf_hash_encode_fwd(xyz.data_ptr(), xyz.size(0), table.data_ptr(),
                                                   static_cast<int>(n_levels), static_cast<int>(log2_table),
                                                   static_cast<int>(n_feat), res.data_ptr(), aabb_min.data(),
                                                   aabb_len.data(), static_cast<int>(variant), read_bf16 ? 1 : 0,
                                                   out.data_ptr(), stream_of(xyz)));
    }
    return out;
}

// xyz (N, 3) f32, g (N, L F) f32, res (L,) int32 -> the table gradient
// (L, 2^log2_table, F) f32, zeroed here and scattered into by kernel E.
Tensor hash_encode_bwd(const Tensor& xyz, const Tensor& g, const Tensor& res, int64_t n_levels, int64_t log2_table,
                       int64_t n_feat, const Float3& aabb_min, const Float3& aabb_len, int64_t variant) {
    const char* name = "hash_encode_bwd";
    require(name, g, ScalarType::Float, xyz);
    require_hash_inputs(name, xyz, res, n_levels);
    require_numel(name, g, xyz.size(0) * n_levels * n_feat, "g");
    TORCH_CHECK_VALUE(log2_table >= 1 && log2_table <= 30, name, ": log2 of the table size ", log2_table,
                      " is outside [1, 30]");
    c10::cuda::CUDAGuard guard(xyz.device());
    Tensor grad = at::zeros({n_levels, int64_t{1} << log2_table, n_feat}, xyz.options());
    if (xyz.size(0) > 0) {
        check_status(name, arcnerf_hash_encode_bwd(xyz.data_ptr(), xyz.size(0), g.data_ptr(),
                                                   static_cast<int>(n_levels), static_cast<int>(log2_table),
                                                   static_cast<int>(n_feat), res.data_ptr(), aabb_min.data(),
                                                   aabb_len.data(), static_cast<int>(variant), grad.data_ptr(),
                                                   stream_of(xyz)));
    }
    return grad;
}

// xyz (N, 3) f32, table (L, 2^log2_table, F) f32, g (N, L F) f32 -> dx (N, 3)
// f32 (kernel K).
Tensor hash_dx(const Tensor& xyz, const Tensor& table, const Tensor& g, const Tensor& res, int64_t log2_table,
               const Float3& aabb_min, const Float3& aabb_len, int64_t variant, bool read_bf16) {
    const char* name = "hash_encode_dx";
    require(name, table, ScalarType::Float, xyz);
    require(name, g, ScalarType::Float, xyz);
    TORCH_CHECK_VALUE(table.dim() == 3 && table.size(1) == (int64_t{1} << log2_table), name,
                      ": expected an (L, 2^", log2_table, ", F) table, got shape ", shape_str(table.sizes()));
    const int64_t n_levels = table.size(0), n_feat = table.size(2);
    require_hash_inputs(name, xyz, res, n_levels);
    require_numel(name, g, xyz.size(0) * n_levels * n_feat, "g");
    c10::cuda::CUDAGuard guard(xyz.device());
    Tensor dx = at::empty({xyz.size(0), 3}, xyz.options());
    if (xyz.size(0) > 0) {
        check_status(name, arcnerf_hash_dx(xyz.data_ptr(), xyz.size(0), table.data_ptr(), g.data_ptr(),
                                           static_cast<int>(n_levels), static_cast<int>(log2_table),
                                           static_cast<int>(n_feat), res.data_ptr(), aabb_min.data(), aabb_len.data(),
                                           static_cast<int>(variant), read_bf16 ? 1 : 0, dx.data_ptr(),
                                           stream_of(xyz)));
    }
    return dx;
}

// The same inputs and g_dx (N, 3) f32 -> the table's gradient (L, 2^log2_table,
// F), zeroed here and scattered into, and g's (N, L F) (kernel L).
std::tuple<Tensor, Tensor> hash_dx_bwd(const Tensor& xyz, const Tensor& table, const Tensor& g, const Tensor& g_dx,
                                       const Tensor& res, int64_t log2_table, const Float3& aabb_min,
                                       const Float3& aabb_len, int64_t variant, bool read_bf16) {
    const char* name = "hash_dx_bwd";
    require(name, table, ScalarType::Float, xyz);
    require(name, g, ScalarType::Float, xyz);
    require(name, g_dx, ScalarType::Float, xyz);
    TORCH_CHECK_VALUE(table.dim() == 3 && table.size(1) == (int64_t{1} << log2_table), name,
                      ": expected an (L, 2^", log2_table, ", F) table, got shape ", shape_str(table.sizes()));
    const int64_t n_levels = table.size(0), n_feat = table.size(2);
    require_hash_inputs(name, xyz, res, n_levels);
    require_numel(name, g, xyz.size(0) * n_levels * n_feat, "g");
    require_numel(name, g_dx, xyz.size(0) * 3, "g_dx");
    c10::cuda::CUDAGuard guard(xyz.device());
    Tensor d_table = at::zeros(table.sizes(), table.options());
    Tensor d_g = at::empty({xyz.size(0), n_levels * n_feat}, xyz.options());
    if (xyz.size(0) > 0) {
        check_status(name, arcnerf_hash_dx_bwd(xyz.data_ptr(), xyz.size(0), table.data_ptr(), g.data_ptr(),
                                               g_dx.data_ptr(), static_cast<int>(n_levels),
                                               static_cast<int>(log2_table), static_cast<int>(n_feat), res.data_ptr(),
                                               aabb_min.data(), aabb_len.data(), static_cast<int>(variant),
                                               read_bf16 ? 1 : 0, d_table.data_ptr(), d_g.data_ptr(), stream_of(xyz)));
    }
    return {d_table, d_g};
}

// ------------------------------------------------------------ C and F

// The compacted stream sigma (K,), rgb (K, 3), z (K,) f32 and per ray off,
// cnt (N_rays,) int64 and bkg (N_rays, 3) f32 or none; returns N_rays.
int64_t require_march_inputs(const char* name, const Tensor& sigma, const Tensor& rgb, const Tensor& z,
                             const Tensor& off, const Tensor& cnt, const std::optional<Tensor>& bkg) {
    require(name, sigma, ScalarType::Float, z);
    require(name, rgb, ScalarType::Float, z);
    require(name, z, ScalarType::Float, z);
    require(name, off, ScalarType::Long, z);
    require(name, cnt, ScalarType::Long, z);
    const int64_t k = z.numel(), n_rays = off.numel();
    require_numel(name, sigma, k, "sigma");
    require_numel(name, rgb, 3 * k, "radiance");
    require_numel(name, cnt, n_rays, "cnt");
    if (bkg) {
        require(name, *bkg, ScalarType::Float, z);
        require_numel(name, *bkg, 3 * n_rays, "bkg");
    }
    require_int(name, n_rays, "rays");
    return n_rays;
}

// The launchers' mode: the sigma mode without or with add_inf_z, or the alpha mode.
int march_mode(bool add_inf_z, bool alpha) {
    return alpha ? 2 : (add_inf_z ? 1 : 0);
}

std::tuple<Tensor, Tensor, Tensor, Tensor> segment_march_fwd(const Tensor& sigma, const Tensor& rgb, const Tensor& z,
                                                             const Tensor& off, const Tensor& cnt, bool add_inf_z,
                                                             const std::optional<Tensor>& bkg, bool white_bkg,
                                                             int64_t group, bool alpha) {
    const char* name = "segment_march";
    const int64_t n_rays = require_march_inputs(name, sigma, rgb, z, off, cnt, bkg);
    TORCH_CHECK_VALUE(group == 32 || group == 8, name, ": kernel C takes groups of 32 or 8 lanes a ray, not ", group);
    c10::cuda::CUDAGuard guard(z.device());
    Tensor out_rgb = at::empty({n_rays, 3}, z.options());
    Tensor depth = at::empty({n_rays}, z.options()), mask = at::empty({n_rays}, z.options());
    Tensor trans_end = at::empty({n_rays}, z.options());
    if (n_rays > 0) {
        check_status(name, arcnerf_segment_march_fwd(sigma.data_ptr(), rgb.data_ptr(), z.data_ptr(), off.data_ptr(),
                                                     cnt.data_ptr(), static_cast<int>(n_rays), z.numel(),
                                                     march_mode(add_inf_z, alpha), bkg ? bkg->data_ptr() : nullptr,
                                                     white_bkg ? 1 : 0, static_cast<int>(group), out_rgb.data_ptr(),
                                                     depth.data_ptr(), mask.data_ptr(), trans_end.data_ptr(),
                                                     stream_of(z)));
    }
    return {out_rgb, depth, mask, trans_end};
}

std::tuple<Tensor, Tensor> segment_march_bwd(const Tensor& sigma, const Tensor& rgb, const Tensor& z,
                                             const Tensor& off, const Tensor& cnt, const Tensor& g_rgb,
                                             const Tensor& g_depth, const Tensor& g_mask, bool add_inf_z,
                                             const std::optional<Tensor>& bkg, bool white_bkg, bool alpha) {
    const char* name = "segment_march_bwd";
    const int64_t n_rays = require_march_inputs(name, sigma, rgb, z, off, cnt, bkg);
    require(name, g_rgb, ScalarType::Float, z);
    require(name, g_depth, ScalarType::Float, z);
    require(name, g_mask, ScalarType::Float, z);
    require_numel(name, g_rgb, 3 * n_rays, "g_rgb");
    require_numel(name, g_depth, n_rays, "g_depth");
    require_numel(name, g_mask, n_rays, "g_mask");
    c10::cuda::CUDAGuard guard(z.device());
    Tensor d_sigma = at::zeros(sigma.sizes(), sigma.options()), d_rgb = at::zeros(rgb.sizes(), rgb.options());
    if (n_rays > 0) {
        check_status(name, arcnerf_segment_march_bwd(sigma.data_ptr(), rgb.data_ptr(), z.data_ptr(), off.data_ptr(),
                                                     cnt.data_ptr(), static_cast<int>(n_rays), z.numel(),
                                                     march_mode(add_inf_z, alpha), bkg ? bkg->data_ptr() : nullptr,
                                                     white_bkg ? 1 : 0, g_rgb.data_ptr(), g_depth.data_ptr(),
                                                     g_mask.data_ptr(), d_sigma.data_ptr(), d_rgb.data_ptr(),
                                                     stream_of(z)));
    }
    return {d_sigma, d_rgb};
}

// ------------------------------------------------------------ G, H, I, J

// table (T, W) f32 or bf16, idx (N,) int32 -> (N, W), rows of 16-byte multiples.
Tensor row_gather(const Tensor& table, const Tensor& idx) {
    const char* name = "row_gather";
    TORCH_CHECK_VALUE((table.scalar_type() == ScalarType::Float || table.scalar_type() == ScalarType::BFloat16) &&
                          table.dim() == 2,
                      name, ": expected a 2-D f32 or bf16 table, got ", dtype_name(table.scalar_type()), " ",
                      shape_str(table.sizes()));
    require(name, table, table.scalar_type(), table);
    require_index(name, idx, 1, table);
    const int64_t row_bytes = table.size(1) * table.element_size();
    TORCH_CHECK_VALUE(row_bytes % 16 == 0, name, ": kernel G moves 16-byte chunks; a row is ", row_bytes, " bytes");
    require_int(name, row_bytes, "a row's bytes");
    c10::cuda::CUDAGuard guard(table.device());
    Tensor out = at::empty({idx.size(0), table.size(1)}, table.options());
    require_aligned(name, table);
    require_aligned(name, out);
    if (idx.size(0) > 0 && table.size(0) > 0) {
        check_status(name, arcnerf_row_gather(table.data_ptr(), table.size(0), static_cast<int>(row_bytes),
                                              idx.data_ptr(), idx.size(0), out.data_ptr(), stream_of(table)));
    }
    return out;
}

// src (M, W) f32, idx (M or 1, N) int32 -> (M, N) f32.
Tensor lane_gather(const Tensor& src, const Tensor& idx) {
    const char* name = "lane_gather";
    require(name, src, ScalarType::Float, src);
    require_index(name, idx, 2, src);
    TORCH_CHECK_VALUE(src.dim() == 2 && (idx.size(0) == 1 || idx.size(0) == src.size(0)), name, ": src ",
                      shape_str(src.sizes()), " and idx ", shape_str(idx.sizes()), " do not match");
    const int64_t m = src.size(0), n = idx.size(1);
    c10::cuda::CUDAGuard guard(src.device());
    Tensor out = at::empty({m, n}, src.options());
    if (m > 0 && n > 0 && src.size(1) > 0) {
        const int64_t stride = idx.size(0) == 1 ? 0 : n;  // one index row serves every row
        check_status(name, arcnerf_lane_gather(src.data_ptr(), m, src.size(1), idx.data_ptr(), stride, n,
                                               out.data_ptr(), stream_of(src)));
    }
    return out;
}

// out (T, W) f32 += g (N, W) f32 at the rows idx (N,) int32, in place; the
// scratch of kernel I's partition route, where it takes that route, is
// allocated here at the size the kernel's source gives.
void scatter_add_rows(const Tensor& out, const Tensor& idx, const Tensor& g) {
    const char* name = "scatter_add_rows";
    require(name, out, ScalarType::Float, out);
    require(name, g, ScalarType::Float, out);
    require_index(name, idx, 1, out);
    TORCH_CHECK_VALUE(out.dim() == 2 && g.dim() == 2 && g.size(0) == idx.size(0) && g.size(1) == out.size(1), name,
                      ": out ", shape_str(out.sizes()), ", idx ", shape_str(idx.sizes()), " and g ",
                      shape_str(g.sizes()), " do not match");
    const int64_t w = out.size(1);
    TORCH_CHECK_VALUE(w == 1 || w % 4 == 0, name, ": kernel I takes rows of 1 or a multiple of 4 floats, not ", w);
    require_int(name, w, "a row's width");
    if (w > 1) {
        require_aligned(name, out);
        require_aligned(name, g);
    }
    if (idx.size(0) > 0 && out.size(0) > 0) {
        c10::cuda::CUDAGuard guard(out.device());
        const int64_t need = arcnerf_scatter_add_rows_scratch_bytes(out.size(0), static_cast<int>(w), idx.size(0));
        Tensor scratch = need > 0 ? at::empty({need}, out.options().dtype(ScalarType::Byte)) : Tensor();
        check_status(name, arcnerf_scatter_add_rows(out.data_ptr(), out.size(0), static_cast<int>(w), idx.data_ptr(),
                                                    g.data_ptr(), idx.size(0), need > 0 ? scratch.data_ptr() : nullptr,
                                                    need, stream_of(out)));
    }
}

// lane0 (K,) int32, vals (K, len(offs) n_feat) f32 -> (K, 128) f32 update rows.
Tensor build_update_rows(const Tensor& lane0, const Tensor& vals, const std::vector<int>& offs, int64_t n_feat) {
    const char* name = "build_update_rows";
    require_index(name, lane0, 1, lane0);
    require(name, vals, ScalarType::Float, lane0);
    const int64_t n_off = static_cast<int64_t>(offs.size()), k = lane0.size(0);
    TORCH_CHECK_VALUE(n_off >= 1 && n_off <= 4 && n_off * n_feat <= 8 && vals.dim() == 2 && vals.size(0) == k &&
                          vals.size(1) == n_off * n_feat,
                      name, ": kernel J takes 1-4 offsets and at most 8 terms; got ", n_off, " offsets, n_feat ",
                      n_feat, ", vals ", shape_str(vals.sizes()));
    c10::cuda::CUDAGuard guard(lane0.device());
    Tensor out = at::empty({k, 128}, vals.options());
    if (k > 0) {
        check_status(name, arcnerf_build_update_rows(lane0.data_ptr(), vals.data_ptr(), k, offs.data(),
                                                     static_cast<int>(n_off), static_cast<int>(n_feat),
                                                     out.data_ptr(), stream_of(lane0)));
    }
    return out;
}

// ------------------------------------------------------------ the sampler

// The ladder's inputs, checked: rays_o, rays_d (n, 3), bitfield (g, g, g)
// bool, rand (n, n_pts) f32 or none; box 6 values, inv_voxel 3. Returns n.
int64_t require_ladder(const char* name, const Tensor& rays_o, const Tensor& rays_d, const Tensor& bitfield,
                       const std::optional<Tensor>& rand, int64_t n_pts, const std::vector<float>& box,
                       const std::vector<float>& inv_voxel) {
    require(name, rays_o, ScalarType::Float, rays_o);
    require(name, rays_d, ScalarType::Float, rays_o);
    require(name, bitfield, ScalarType::Bool, rays_o);
    const int64_t n = rays_o.size(0);
    TORCH_CHECK_VALUE(rays_o.dim() == 2 && rays_o.size(1) == 3, name, ": expected rays (n, 3), got ",
                      shape_str(rays_o.sizes()));
    require_numel(name, rays_d, 3 * n, "rays_d");
    TORCH_CHECK_VALUE(bitfield.dim() == 3 && bitfield.size(0) == bitfield.size(1) &&
                          bitfield.size(0) == bitfield.size(2),
                      name, ": expected a cubic bitfield, got shape ", shape_str(bitfield.sizes()));
    TORCH_CHECK_VALUE(box.size() == 6 && inv_voxel.size() == 3, name, ": box takes 6 values and inv_voxel 3");
    if (rand) {
        require(name, *rand, ScalarType::Float, rays_o);
        require_numel(name, *rand, n * n_pts, "rand");
    }
    require_int(name, n, "rays");
    require_int(name, n_pts, "samples a ray");
    return n;
}

// -> off, cnt (n,) int64, n_valid () int64, ray_has (n,) bool (the ray hits
// the box and keeps a sample), and for the write: near_far (n, 2) f32,
// clamp (n, 2) f32 (the jitter's clamp; (0, 2) without rand) and first_z
// (1,) f32.
std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor> sample_count(
        const Tensor& rays_o, const Tensor& rays_d, const Tensor& bitfield, const std::optional<Tensor>& rand,
        int64_t n_pts, double fix_t, const std::vector<float>& box, const std::vector<float>& inv_voxel, int64_t cap,
        int64_t budget, bool sections) {
    const char* name = "sample_count";
    const int64_t n = require_ladder(name, rays_o, rays_d, bitfield, rand, n_pts, box, inv_voxel);
    require_int(name, cap, "cap");
    c10::cuda::CUDAGuard guard(rays_o.device());
    const auto f32 = rays_o.options(), i64 = f32.dtype(ScalarType::Long);
    Tensor tot = at::empty({n}, f32.dtype(ScalarType::Int)), near_far = at::empty({n, 2}, f32);
    Tensor clamp = at::empty({rand ? n : 0, 2}, f32), first_z = at::empty({1}, f32);
    Tensor ray_has = at::empty({n}, f32.dtype(ScalarType::Bool));
    Tensor off = at::empty({n}, i64), cnt = at::empty({n}, i64), n_valid = at::empty(at::IntArrayRef{}, i64);
    check_status(name, arcnerf_sample_count(rays_o.data_ptr(), rays_d.data_ptr(), static_cast<int>(n),
                                            bitfield.data_ptr(), static_cast<int>(bitfield.size(0)), box.data(),
                                            inv_voxel.data(), rand ? rand->data_ptr() : nullptr,
                                            static_cast<int>(n_pts), static_cast<float>(fix_t), static_cast<int>(cap),
                                            budget, sections ? 1 : 0, tot.data_ptr(), near_far.data_ptr(),
                                            clamp.data_ptr(),
                                            first_z.data_ptr(), ray_has.data_ptr(), off.data_ptr(), cnt.data_ptr(),
                                            n_valid.data_ptr(), stream_of(rays_o)));
    return {off, cnt, n_valid, ray_has, near_far, clamp, first_z};
}

// The same ladder and sample_count's outputs -> the stream: z (budget,), pts
// and dirs (budget, 3) f32, and with sections len (budget,) f32 (else none).
std::tuple<Tensor, Tensor, Tensor, std::optional<Tensor>> sample_write(const Tensor& rays_o, const Tensor& rays_d, const Tensor& bitfield,
                                                const std::optional<Tensor>& rand, int64_t n_pts, double fix_t,
                                                const std::vector<float>& box, const std::vector<float>& inv_voxel,
                                                const Tensor& near_far, const Tensor& clamp, const Tensor& first_z,
                                                const Tensor& off, const Tensor& cnt, const Tensor& n_valid,
                                                int64_t budget, bool sections, int64_t cap) {
    const char* name = "sample_write";
    const int64_t n = require_ladder(name, rays_o, rays_d, bitfield, rand, n_pts, box, inv_voxel);
    require(name, near_far, ScalarType::Float, rays_o);
    require(name, clamp, ScalarType::Float, rays_o);
    require(name, first_z, ScalarType::Float, rays_o);
    require(name, off, ScalarType::Long, rays_o);
    require(name, cnt, ScalarType::Long, rays_o);
    require(name, n_valid, ScalarType::Long, rays_o);
    require_numel(name, near_far, 2 * n, "near_far");
    require_numel(name, clamp, rand ? 2 * n : 0, "clamp");
    require_numel(name, first_z, 1, "first_z");
    require_numel(name, off, n, "off");
    require_numel(name, cnt, n, "cnt");
    require_numel(name, n_valid, 1, "n_valid");
    require_int(name, cap, "cap");
    c10::cuda::CUDAGuard guard(rays_o.device());
    Tensor z = at::empty({budget}, rays_o.options());
    Tensor pts = at::empty({budget, 3}, rays_o.options()), dirs = at::empty({budget, 3}, rays_o.options());
    std::optional<Tensor> len;
    if (sections) len = at::empty({budget}, rays_o.options());
    check_status(name, arcnerf_sample_write(rays_o.data_ptr(), rays_d.data_ptr(), static_cast<int>(n),
                                            bitfield.data_ptr(), static_cast<int>(bitfield.size(0)), box.data(),
                                            inv_voxel.data(), rand ? rand->data_ptr() : nullptr,
                                            static_cast<int>(n_pts), static_cast<float>(fix_t), near_far.data_ptr(),
                                            clamp.data_ptr(), first_z.data_ptr(), off.data_ptr(), cnt.data_ptr(),
                                            n_valid.data_ptr(), budget, static_cast<int>(cap), z.data_ptr(),
                                            pts.data_ptr(), dirs.data_ptr(), len ? len->data_ptr() : nullptr,
                                            stream_of(rays_o)));
    return {z, pts, dirs, len};
}

}  // namespace

PYBIND11_MODULE(ARCNERF_MODULE, m) {
    m.doc() = "arcnerf_torch's CUDA kernels A-L and the sampler (see arcnerf_torch/ops/cuda_lib.py)";
    namespace py = pybind11;
    m.def("fused_mlp_fwd", &fused_mlp_fwd, py::arg("x"), py::arg("packed"), py::arg("din_pad"), py::arg("n_hidden"),
          py::arg("d_out"), py::arg("dout_pad"), py::arg("save_pre"));
    m.def("fused_mlp_bwd", &fused_mlp_bwd, py::arg("x"), py::arg("g"), py::arg("packed"), py::arg("pre"),
          py::arg("din_pad"), py::arg("n_hidden"), py::arg("d_out"), py::arg("dout_pad"));
    m.def("hash_encode_fwd", &hash_encode_fwd, py::arg("xyz"), py::arg("table"), py::arg("res"),
          py::arg("log2_table"), py::arg("aabb_min"), py::arg("aabb_len"), py::arg("variant"), py::arg("read_bf16"));
    m.def("hash_encode_bwd", &hash_encode_bwd, py::arg("xyz"), py::arg("g"), py::arg("res"), py::arg("n_levels"),
          py::arg("log2_table"), py::arg("n_feat"), py::arg("aabb_min"), py::arg("aabb_len"), py::arg("variant"));
    m.def("hash_dx", &hash_dx, py::arg("xyz"), py::arg("table"), py::arg("g"), py::arg("res"), py::arg("log2_table"),
          py::arg("aabb_min"), py::arg("aabb_len"), py::arg("variant"), py::arg("read_bf16"));
    m.def("hash_dx_bwd", &hash_dx_bwd, py::arg("xyz"), py::arg("table"), py::arg("g"), py::arg("g_dx"), py::arg("res"),
          py::arg("log2_table"), py::arg("aabb_min"), py::arg("aabb_len"), py::arg("variant"), py::arg("read_bf16"));
    m.def("segment_march_fwd", &segment_march_fwd, py::arg("sigma"), py::arg("rgb"), py::arg("z"), py::arg("off"),
          py::arg("cnt"), py::arg("add_inf_z"), py::arg("bkg"), py::arg("white_bkg"), py::arg("group") = 32,
          py::arg("alpha") = false);
    m.def("segment_march_bwd", &segment_march_bwd, py::arg("sigma"), py::arg("rgb"), py::arg("z"), py::arg("off"),
          py::arg("cnt"), py::arg("g_rgb"), py::arg("g_depth"), py::arg("g_mask"), py::arg("add_inf_z"),
          py::arg("bkg"), py::arg("white_bkg"), py::arg("alpha") = false);
    m.def("row_gather", &row_gather, py::arg("table"), py::arg("idx"));
    m.def("lane_gather", &lane_gather, py::arg("src"), py::arg("idx"));
    m.def("scatter_add_rows", &scatter_add_rows, py::arg("out"), py::arg("idx"), py::arg("g"));
    m.def("build_update_rows", &build_update_rows, py::arg("lane0"), py::arg("vals"), py::arg("offs"),
          py::arg("n_feat"));
    m.def("sample_count", &sample_count, py::arg("rays_o"), py::arg("rays_d"), py::arg("bitfield"), py::arg("rand"),
          py::arg("n_pts"), py::arg("fix_t"), py::arg("box"), py::arg("inv_voxel"), py::arg("cap"), py::arg("budget"),
          py::arg("sections") = false);
    m.def("sample_write", &sample_write, py::arg("rays_o"), py::arg("rays_d"), py::arg("bitfield"), py::arg("rand"),
          py::arg("n_pts"), py::arg("fix_t"), py::arg("box"), py::arg("inv_voxel"), py::arg("near_far"),
          py::arg("clamp"), py::arg("first_z"), py::arg("off"), py::arg("cnt"), py::arg("n_valid"),
          py::arg("budget"), py::arg("sections") = false, py::arg("cap") = 0);
}
