// The sampler and its compaction in one: rays in, the compacted sample
// stream out, with no (rays, n_pts) tensor in between.
//
// Replaces no single TPU kernel. The JAX package samples and compacts in
// XLA code: arcnerf_tpu/models/base_modules/obj_bound.py _occ_mask_soa
// (:60), geometry/volume.py get_flat_voxel_idx_from_coords (:288) and
// check_flat_in_occ_voxel (:307), render/ray_helper.py
// get_zvals_from_near_far_fix_step (:162) and models/fg_model.py
// _compact_sel_aux (:227). Ported as plain PyTorch, those are ~60
// operations that build and walk the (rays, 512) grid of the fix-step
// ladder several times, the largest cost of every training step and served
// frame (PERF.md §5); this kernel takes their place on the card.
//
// What it computes, ray r and ladder slot j (the plain version,
// arcnerf_torch/models/base_modules/sample_compact.py, composes the
// program's own functions):
// - near and far: the slab test against the volume's box
//   (geometry/ray.py aabb_ray_intersection: eps 1e-7, 0 and 0 where the
//   ray misses);
// - z_j = min(max(near + j fix_t, near), far); slot j > 0 is a duplicate
//   where z_j == z_(j-1) (the tail clamped at far);
// - in training, a slot that is not a duplicate is jittered within its
//   interval by the drawn rand_j (perturb_interval), and every slot is
//   then clamped to [slot 0, last non-duplicate slot] after the jitter;
// - the point o + z d, its voxel (the coordinate less the grid's start,
//   times the reciprocal of the voxel size, truncated) and the bitfield's
//   byte there: valid = not a duplicate, inside the grid, occupied;
// - at inference under a cap, only the first `cap` valid samples;
// - the stream: each valid sample at row off_r + its rank in the ray, in
//   ladder order, while below the budget; rows past the valid count hold
//   ray 0's first sample (z, its point and direction), as the plain
//   version's index 0 gives them;
// - in the sections mode (an SDF's sections, JAX Neus.handle_mid_pts on
//   left-compacted rows; the plain version is sdf_sections), a ray with c
//   valid samples z_0 < ... < z_(c-1) counts min(c + 1, n_pts) sections
//   (none for c = 0): section j < c - 1 spans z_j to z_(j+1), section
//   c - 1 spans z_(c-1) to z_(c-1) + 2 sd with sd = (z_(c-1) - z_0) /
//   n_pts / 2 (a multiply by the f32 reciprocal of n_pts), and section c
//   has length 0 there. A row holds the section's
//   mid point (z, the point) and its length (len); the budget applies to
//   sections, and padding rows have length 0.
//
// What bounds it on the H100: in a training step (16384 rays x 512 slots,
// budget 2^18) the jitter read once (33.5 MB) and the stream written
// (2^18 rows x 28 bytes, 7.3 MB), ~12 us at 3.35 TB/s; in serving (rays in,
// no jitter, cap 16) a few us. In practice the 8.4 M slots' arithmetic and
// bitfield probes (the 2 MB bitfield sits in L2) set the time.
//
// Design, three launches:
// 1. count (sample_count_kernel): a warp a ray intersects the box, then
//    walks its ladder 32 consecutive slots a step, so the jitter's reads
//    are coalesced; each lane recomputes its slot's z, duplicate test,
//    jitter and voxel from the ray alone, and __ballot_sync / __popc count
//    the valid ones. The walk ends where the ladder reaches far (every
//    later slot repeats it) or the cap is met. With jitter a first walk,
//    arithmetic only, counts the non-duplicate slots for the clamp.
// 2. scan (sample_scan_kernel): one block scans the counts into off, cnt
//    = min(max(budget - off, 0), count) and the total, all on the device,
//    kScanRound counts a round: read and written coalesced through shared
//    memory, kScanPer consecutive counts a thread in between (its row
//    padded a word every 32, so that no two lanes share a bank).
// 3. write (sample_write_kernel): the walk again for rays with cnt > 0, the
//    in-ray rank from the ballot, ending at cnt; near, far and the clamp
//    come from the count's walk. Blocks past the rays fill the padding
//    rows. In the sections mode each valid sample writes the section that
//    ends at it, its start z from the next lower valid lane by a shuffle
//    (or carried from the walk's earlier steps), and lane 0 writes the
//    ray's last two sections after the walk.
// The mode is a template parameter: the samples mode compiles as it did
// before the sections mode existed.
// Nothing is read back to the host, and the outputs have fixed sizes (the
// budget), so a training step captured as a CUDA graph replays it.
// Every rounding is the plain version's as PyTorch's CUDA operators give
// it: the _rn intrinsics keep nvcc from contracting a product and a sum
// into an FMA (PyTorch runs each as its own operator), and the voxel
// coordinate is multiplied by the reciprocal rounded on the host, as
// PyTorch divides by a Python number on the card. So the stream is the
// plain version's bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // count and write: a warp a ray
constexpr int kRaysPerBlock = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;  // consecutive counts a scan thread sums
constexpr int kScanRound = kScanThreads * kScanPer;
constexpr int kMaxSlots = 1 << 17;  // a round's sum (kScanRound rays x slots) fits an int
constexpr int kPadBlocks = 264;  // write: at most this many blocks fill the padding
constexpr unsigned kFull = 0xffffffffu;

struct Ladder {
    const float* rays_o;  // (n_rays, 3)
    const float* rays_d;
    const unsigned char* bitfield;  // (n_grid^3,) bytes, 0 or 1
    const float* rand;              // (n_rays, n_pts) uniform jitter, or null (no jitter)
    int n_rays, n_pts, n_grid;
    float fix_t;
    float box_min[3], box_max[3];  // the volume's box; box_min is also the grid's start
    float inv_voxel[3];
};

struct Ray {
    float o[3], d[3];
    float near, far;
    const float* rand;  // the ray's row of draws, or null
    float first, last;  // the jitter's clamp: slot 0 and the last non-duplicate slot, jittered
};

// The ray's origin, direction and draws; near and far are the caller's.
__device__ __forceinline__ Ray load_ray(const Ladder& p, int ray) {
    Ray r;
    for (int k = 0; k < 3; ++k) {
        r.o[k] = p.rays_o[3 * ray + k];
        r.d[k] = p.rays_d[3 * ray + k];
    }
    r.rand = p.rand != nullptr ? p.rand + static_cast<int64_t>(ray) * p.n_pts : nullptr;
    r.near = r.far = r.first = r.last = 0.f;
    return r;
}

// The slab test against the box: sets near and far (0 and 0 on a miss)
// and returns whether the ray hits. A direction component under eps is
// parallel to its slabs: the ray misses if its origin lies outside them.
__device__ __forceinline__ bool intersect(const Ladder& p, Ray& r) {
    constexpr float kEps = 1e-7f;
    const float inf = __int_as_float(0x7f800000);
    bool miss_parallel = false;
    float near_raw = -inf, far_raw = inf;
    for (int k = 0; k < 3; ++k) {
        const bool parallel = fabsf(r.d[k]) < kEps;
        miss_parallel |= parallel && (r.o[k] < p.box_min[k] || r.o[k] > p.box_max[k]);
        const float d = parallel ? 1.f : r.d[k];
        const float t1 = __fdiv_rn(__fsub_rn(p.box_min[k], r.o[k]), d);
        const float t2 = __fdiv_rn(__fsub_rn(p.box_max[k], r.o[k]), d);
        near_raw = fmaxf(near_raw, parallel ? -inf : fminf(t1, t2));
        far_raw = fminf(far_raw, parallel ? inf : fmaxf(t1, t2));
    }
    const bool hit = !miss_parallel && near_raw <= far_raw && far_raw >= 0.f;
    r.near = hit ? __fadd_rn(fmaxf(near_raw, 0.f), kEps) : 0.f;
    r.far = hit ? __fsub_rn(fmaxf(far_raw, 0.f), kEps) : 0.f;
    return hit;
}

// The fix-step ladder before the jitter.
__device__ __forceinline__ float ladder_z(const Ray& r, float fix_t, int j) {
    return fminf(fmaxf(__fadd_rn(r.near, __fmul_rn(static_cast<float>(j), fix_t)), r.near), r.far);
}

// Whether the ladder ends within the slots up to j: it has reached far, so
// every later slot repeats the one before.
__device__ __forceinline__ bool at_far(const Ray& r, float fix_t, int j) {
    return ladder_z(r, fix_t, j) == r.far;
}

// Slot j after the jitter and before the clamp: a duplicate keeps its z,
// others move to lower + (upper - lower) rand_j between the midpoints.
__device__ __forceinline__ float jittered(const Ray& r, float fix_t, int n_pts, int j) {
    const float z = ladder_z(r, fix_t, j);
    const float prev = j > 0 ? ladder_z(r, fix_t, j - 1) : z;
    if (j > 0 && z == prev) return z;
    const float lower = j > 0 ? __fmul_rn(0.5f, __fadd_rn(z, prev)) : z;
    const float upper = j < n_pts - 1 ? __fmul_rn(0.5f, __fadd_rn(ladder_z(r, fix_t, j + 1), z)) : z;
    return __fadd_rn(lower, __fmul_rn(__fsub_rn(upper, lower), r.rand[j]));
}

// Slot j of ray r: its z and point, and whether the sample is valid.
__device__ __forceinline__ bool sample_at(const Ladder& p, const Ray& r, int j, float& z, float xyz[3]) {
    const float z0 = ladder_z(r, p.fix_t, j);
    const bool dup = j > 0 && z0 == ladder_z(r, p.fix_t, j - 1);
    z = z0;
    if (r.rand != nullptr) z = fminf(fmaxf(dup ? z0 : jittered(r, p.fix_t, p.n_pts, j), r.first), r.last);
    if (dup) return false;
    int idx[3];
    for (int k = 0; k < 3; ++k) {
        xyz[k] = __fadd_rn(r.o[k], __fmul_rn(z, r.d[k]));
        const float f = __fmul_rn(__fsub_rn(xyz[k], p.box_min[k]), p.inv_voxel[k]);
        if (!(f >= 0.f && f < static_cast<float>(p.n_grid))) return false;
        idx[k] = static_cast<int>(f);  // truncation, the floor on [0, n_grid)
    }
    return p.bitfield[(idx[0] * p.n_grid + idx[1]) * p.n_grid + idx[2]] != 0;
}

template <bool Sections>
__global__ void __launch_bounds__(kThreads) sample_count_kernel(Ladder p, int cap, int* __restrict__ tot,
                                                                float2* __restrict__ near_far,
                                                                float2* __restrict__ clamp,
                                                                float* __restrict__ first_z,
                                                                bool* __restrict__ ray_has) {
    const int lane = threadIdx.x % 32;
    const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
    if (ray >= p.n_rays) return;  // a warp leaves as a whole: its lanes share the ray
    Ray r = load_ray(p, ray);
    const bool hit = intersect(p, r);
    if (lane == 0) near_far[ray] = make_float2(r.near, r.far);
    if (r.rand != nullptr) {
        int kept = 0;
        for (int base = 0; base < p.n_pts; base += 32) {
            const int j = base + lane;
            const bool nd = j < p.n_pts && !(j > 0 && ladder_z(r, p.fix_t, j) == ladder_z(r, p.fix_t, j - 1));
            kept += __popc(__ballot_sync(kFull, nd));
            if (at_far(r, p.fix_t, min(base + 31, p.n_pts - 1))) break;
        }
        r.first = jittered(r, p.fix_t, p.n_pts, 0);
        r.last = jittered(r, p.fix_t, p.n_pts, max(kept - 1, 0));
        if (lane == 0) clamp[ray] = make_float2(r.first, r.last);
    }
    int count = 0;
    for (int base = 0; base < p.n_pts; base += 32) {
        const int j = base + lane;
        float z, xyz[3];
        const bool valid = j < p.n_pts && sample_at(p, r, j, z, xyz);
        count += __popc(__ballot_sync(kFull, valid));
        if ((cap > 0 && count >= cap) || at_far(r, p.fix_t, min(base + 31, p.n_pts - 1))) break;
    }
    if (cap > 0) count = min(count, cap);
    if (lane != 0) return;
    tot[ray] = Sections ? (count > 0 ? min(count + 1, p.n_pts) : 0) : count;
    ray_has[ray] = hit && count > 0;
    if (ray == 0) *first_z = r.rand != nullptr ? fminf(r.first, r.last) : ladder_z(r, p.fix_t, 0);
}

// Count k of a round in shared memory: a word of padding every 32.
__host__ __device__ constexpr int scan_slot(int k) {
    return k + k / 32;
}

// off = the exclusive scan of tot, cnt = min(max(budget - off, 0), tot),
// n_valid = the sum; one block, kScanRound counts a round.
__global__ void __launch_bounds__(kScanThreads) sample_scan_kernel(const int* __restrict__ tot, int n_rays,
                                                                   int64_t budget, int64_t* __restrict__ off,
                                                                   int64_t* __restrict__ cnt,
                                                                   int64_t* __restrict__ n_valid) {
    __shared__ int round_off[scan_slot(kScanRound) + 1];  // a round's counts, then its exclusive offsets
    __shared__ int warp_off[kScanThreads / 32];
    __shared__ int round_total;
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    int64_t carry = 0;
    for (int base = 0; base < n_rays; base += kScanRound) {
        const int n = n_rays - base < kScanRound ? n_rays - base : kScanRound;
#pragma unroll
        for (int i = 0; i < kScanPer; ++i) {
            const int k = i * kScanThreads + t;
            round_off[scan_slot(k)] = k < n ? tot[base + k] : 0;
        }
        __syncthreads();
        int v[kScanPer], sum = 0;
#pragma unroll
        for (int i = 0; i < kScanPer; ++i) {
            v[i] = round_off[scan_slot(t * kScanPer + i)];
            sum += v[i];
        }
        int incl = sum;
#pragma unroll
        for (int s = 1; s < 32; s *= 2) {
            const int y = __shfl_up_sync(kFull, incl, s);
            if (lane >= s) incl += y;
        }
        if (lane == 31) warp_off[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            const int w = warp_off[lane];
            int wi = w;
#pragma unroll
            for (int s = 1; s < 32; s *= 2) {
                const int y = __shfl_up_sync(kFull, wi, s);
                if (lane >= s) wi += y;
            }
            warp_off[lane] = wi - w;
            if (lane == 31) round_total = wi;
        }
        __syncthreads();
        int run = warp_off[warp] + incl - sum;
#pragma unroll
        for (int i = 0; i < kScanPer; ++i) {
            round_off[scan_slot(t * kScanPer + i)] = run;
            run += v[i];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kScanPer; ++i) {
            const int k = i * kScanThreads + t;
            if (k < n) {
                const int o = round_off[scan_slot(k)];
                const int count = (k + 1 < n ? round_off[scan_slot(k + 1)] : round_total) - o;
                const int64_t at = carry + o;
                const int64_t room = budget > at ? budget - at : 0;
                off[base + k] = at;
                cnt[base + k] = room < count ? room : count;
            }
        }
        carry += round_total;
        __syncthreads();  // round_off, warp_off and round_total are rewritten next round
    }
    if (t == 0) *n_valid = carry;
}

// Section `row` (relative to the ray's off) from z0 to z1: its mid z, the
// point there and the ray's direction, and its length.
__device__ __forceinline__ void write_section(const Ray& r, int64_t row, float z0, float z1, float* __restrict__ z_out,
                                              float* __restrict__ pts, float* __restrict__ dirs,
                                              float* __restrict__ len) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(z1, z0));
    z_out[row] = mid;
    len[row] = __fsub_rn(z1, z0);
    for (int k = 0; k < 3; ++k) {
        pts[3 * row + k] = __fadd_rn(r.o[k], __fmul_rn(mid, r.d[k]));
        dirs[3 * row + k] = r.d[k];
    }
}

template <bool Sections>
__global__ void __launch_bounds__(kThreads) sample_write_kernel(
        Ladder p, const float2* __restrict__ near_far, const float2* __restrict__ clamp,
        const float* __restrict__ first_z,
        const int64_t* __restrict__ off, const int64_t* __restrict__ cnt, const int64_t* __restrict__ n_valid,
        int64_t budget, int ray_blocks, int cap, float* __restrict__ z_out, float* __restrict__ pts,
        float* __restrict__ dirs, float* __restrict__ len) {
    if (static_cast<int>(blockIdx.x) >= ray_blocks) {
        // the padding rows [min(n_valid, budget), budget): ray 0's first sample
        const int64_t from = *n_valid < budget ? *n_valid : budget;
        const float z = *first_z;
        const float d0 = p.rays_d[0], d1 = p.rays_d[1], d2 = p.rays_d[2];
        const float x0 = __fadd_rn(p.rays_o[0], __fmul_rn(z, d0));
        const float x1 = __fadd_rn(p.rays_o[1], __fmul_rn(z, d1));
        const float x2 = __fadd_rn(p.rays_o[2], __fmul_rn(z, d2));
        const int64_t stride = static_cast<int64_t>(gridDim.x - ray_blocks) * kThreads;
        for (int64_t row = from + static_cast<int64_t>(blockIdx.x - ray_blocks) * kThreads + threadIdx.x;
             row < budget; row += stride) {
            z_out[row] = z;
            pts[3 * row + 0] = x0;
            pts[3 * row + 1] = x1;
            pts[3 * row + 2] = x2;
            dirs[3 * row + 0] = d0;
            dirs[3 * row + 1] = d1;
            dirs[3 * row + 2] = d2;
            if constexpr (Sections) len[row] = 0.f;
        }
        return;
    }
    const int lane = threadIdx.x % 32;
    const int ray = blockIdx.x * kRaysPerBlock + threadIdx.x / 32;
    if (ray >= p.n_rays) return;
    const int64_t c = cnt[ray];
    if (c <= 0) return;
    const int64_t o = off[ray];
    Ray r = load_ray(p, ray);
    const float2 nf = near_far[ray];
    r.near = nf.x;
    r.far = nf.y;
    if (r.rand != nullptr) {
        const float2 cl = clamp[ray];
        r.first = cl.x;
        r.last = cl.y;
    }
    int64_t rank = 0;
    float prev_z = 0.f, first = 0.f;  // sections: the last valid z of the steps before, and the ray's first
    const int64_t last = cap > 0 ? cap : p.n_pts;  // sections: the ray's samples end at the cap
    for (int base = 0; base < p.n_pts; base += 32) {
        const int j = base + lane;
        float z = 0.f, xyz[3];
        bool valid = j < p.n_pts && sample_at(p, r, j, z, xyz);
        if constexpr (Sections) {  // every lane votes, then the samples past the cap drop out
            const unsigned votes = __ballot_sync(kFull, valid);
            valid = valid && rank + __popc(votes & ((1u << lane) - 1u)) < last;
        }
        const unsigned ballot = __ballot_sync(kFull, valid);
        const unsigned below = ballot & ((1u << lane) - 1u);
        const int64_t mine = rank + __popc(below);
        if constexpr (Sections) {
            // the section that ends at this sample starts at the next lower valid one
            const float z_below = __shfl_sync(kFull, z, below ? 31 - __clz(below) : lane);
            if (valid && mine >= 1 && mine - 1 < c) write_section(r, o + mine - 1, below ? z_below : prev_z, z, z_out,
                                                                  pts, dirs, len);
            const float z_top = __shfl_sync(kFull, z, ballot ? 31 - __clz(ballot) : 0);
            const float z_low = __shfl_sync(kFull, z, ballot ? __ffs(ballot) - 1 : 0);
            if (ballot) {
                if (rank == 0) first = z_low;
                prev_z = z_top;
            }
        } else if (valid && mine < c) {
            const int64_t row = o + mine;
            z_out[row] = z;
            for (int k = 0; k < 3; ++k) {
                pts[3 * row + k] = xyz[k];
                dirs[3 * row + k] = r.d[k];
            }
        }
        rank += __popc(ballot);
        if (rank >= (Sections ? min(c + 1, last) : c) || at_far(r, p.fix_t, min(base + 31, p.n_pts - 1))) break;
    }
    if constexpr (Sections) {
        // the last two sections: to z_(c-1) + 2 sd, then of length 0 there. A
        // walk cut short by cnt saw rank >= cnt + 1 samples, and writes neither
        if (lane != 0 || rank == 0) return;
        const float sd = __fmul_rn(__fmul_rn(__fsub_rn(prev_z, first), __frcp_rn(static_cast<float>(p.n_pts))), 0.5f);
        const float fin = __fadd_rn(prev_z, __fmul_rn(sd, 2.f));
        if (rank - 1 < c) write_section(r, o + rank - 1, prev_z, fin, z_out, pts, dirs, len);
        if (rank < c) write_section(r, o + rank, fin, fin, z_out, pts, dirs, len);
    }
}

Ladder make_ladder(const void* rays_o, const void* rays_d, int n_rays, const void* bitfield, int n_grid,
                   const float* box, const float* inv_voxel, const void* rand, int n_pts, float fix_t) {
    Ladder p;
    p.rays_o = static_cast<const float*>(rays_o);
    p.rays_d = static_cast<const float*>(rays_d);
    p.bitfield = static_cast<const unsigned char*>(bitfield);
    p.rand = static_cast<const float*>(rand);
    p.n_rays = n_rays;
    p.n_pts = n_pts;
    p.n_grid = n_grid;
    p.fix_t = fix_t;
    for (int k = 0; k < 3; ++k) {
        p.box_min[k] = box[k];
        p.box_max[k] = box[3 + k];
        p.inv_voxel[k] = inv_voxel[k];
    }
    return p;
}

bool bad_ladder(int n_rays, int n_grid, int n_pts, long long budget) {
    // n_grid^3 fits an int, and so does a scan round's sum
    return n_rays <= 0 || n_grid <= 0 || n_grid > 1290 || n_pts <= 0 || n_pts > kMaxSlots || budget <= 0;
}

}  // namespace

// rays_o, rays_d (n_rays, 3) f32; bitfield (n_grid^3,) bytes; box: 6 host
// floats (the volume's lower corner, then its upper corner); inv_voxel: 3
// (the reciprocal voxel size); rand (n_rays, n_pts) f32 or null. Count and
// scan: tot (n_rays,) int32 scratch, near_far (n_rays, 2) f32, clamp
// (n_rays, 2) f32 (written with rand), first_z (1,) f32, ray_has (n_rays,)
// bool (the ray hits the box and keeps a sample), off, cnt (n_rays,) int64,
// n_valid () int64.
extern "C" int arcnerf_sample_count(const void* rays_o, const void* rays_d, int n_rays, const void* bitfield,
                                    int n_grid, const float* box, const float* inv_voxel, const void* rand, int n_pts,
                                    float fix_t, int cap, long long budget, int sections, void* tot, void* near_far,
                                    void* clamp, void* first_z, void* ray_has, void* off, void* cnt, void* n_valid,
                                    void* stream) {
    if (bad_ladder(n_rays, n_grid, n_pts, budget) || cap < 0) return ARCNERF_BAD_ARGUMENT;
    const Ladder p = make_ladder(rays_o, rays_d, n_rays, bitfield, n_grid, box, inv_voxel, rand, n_pts, fix_t);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    auto* kernel = sections ? sample_count_kernel<true> : sample_count_kernel<false>;
    kernel<<<blocks, kThreads, 0, s>>>(p, cap, static_cast<int*>(tot), static_cast<float2*>(near_far),
                                       static_cast<float2*>(clamp), static_cast<float*>(first_z),
                                       static_cast<bool*>(ray_has));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sample_scan_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const int*>(tot), n_rays, budget,
                                                  static_cast<int64_t*>(off), static_cast<int64_t*>(cnt),
                                                  static_cast<int64_t*>(n_valid));
    return static_cast<int>(cudaGetLastError());
}

// The same ladder, the count's near_far, clamp and first_z, and the scan's
// off, cnt, n_valid -> the stream: z (budget,), pts and dirs (budget, 3) f32,
// and in the sections mode (len non-null) len (budget,) f32, a ray's samples
// ending at the count's cap (0: none).
extern "C" int arcnerf_sample_write(const void* rays_o, const void* rays_d, int n_rays, const void* bitfield,
                                    int n_grid, const float* box, const float* inv_voxel, const void* rand, int n_pts,
                                    float fix_t, const void* near_far, const void* clamp, const void* first_z,
                                    const void* off, const void* cnt, const void* n_valid, long long budget, int cap,
                                    void* z, void* pts, void* dirs, void* len, void* stream) {
    if (cap < 0) return ARCNERF_BAD_ARGUMENT;
    if (bad_ladder(n_rays, n_grid, n_pts, budget)) return ARCNERF_BAD_ARGUMENT;
    const Ladder p = make_ladder(rays_o, rays_d, n_rays, bitfield, n_grid, box, inv_voxel, rand, n_pts, fix_t);
    const int ray_blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
    const long long pad_rounds = (budget + kThreads - 1) / kThreads;
    const int pad_blocks = pad_rounds < kPadBlocks ? static_cast<int>(pad_rounds) : kPadBlocks;
    auto* kernel = len != nullptr ? sample_write_kernel<true> : sample_write_kernel<false>;
    kernel<<<ray_blocks + pad_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const float2*>(near_far), static_cast<const float2*>(clamp), static_cast<const float*>(first_z),
        static_cast<const int64_t*>(off), static_cast<const int64_t*>(cnt), static_cast<const int64_t*>(n_valid),
        budget, ray_blocks, cap, static_cast<float*>(z), static_cast<float*>(pts), static_cast<float*>(dirs),
        static_cast<float*>(len));
    return static_cast<int>(cudaGetLastError());
}
