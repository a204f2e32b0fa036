"""Ray generation, z-value sampling with its training jitter, compositing
on the compacted stream with kernels C and F, and dense compositing on the
(rays, samples) grid.

Counterpart of ``arcnerf_tpu/render/ray_helper.py`` (get_rays,
get_near_far_from_rays, get_zvals_from_near_far,
get_zvals_from_near_far_fix_step, perturb_interval,
perturb_interval_with_mask, sample_pdf (its sample_cdf folded in), alpha_to_weights,
scattered_deltas, ray_marching, segment_march). ``segment_march`` replaces the
JAX scan-and-cumsum formulation with the CUDA kernel in
``csrc/segment_march.cu`` and its gradient with ``csrc/segment_march_bwd.cu``;
``segment_march_reference`` and ``segment_march_bwd_reference`` are the
plain versions. The jitter takes a ``torch.Generator`` or an explicit
uniform tensor (the JAX package draws ``jax.random.uniform``). NDC rays are
not ported.
"""

import torch

from ..geometry.ray import sphere_ray_intersection
from ..geometry.transformation import normalize
from ..ops import cuda_lib


def _pixel_to_world(pixels, intrinsic, c2w):
    """pixels (N, 2) at depth 1 -> world points (N, 3); the JAX
    pixel_to_cam + rotate_points chain, term by term."""
    fx, fy, cx, cy, s = intrinsic[0, 0], intrinsic[1, 1], intrinsic[0, 2], intrinsic[1, 2], intrinsic[0, 1]
    i, j = pixels[:, 0], pixels[:, 1]
    cam = ((i - (s * (j - cy) / fy) - cx) / fx, (j - cy) / fy, torch.ones_like(i))
    rot, t = c2w[:3, :3], c2w[:3, 3]
    return torch.stack([cam[0] * rot[k, 0] + cam[1] * rot[k, 1] + cam[2] * rot[k, 2] + t[k] for k in range(3)], -1)


def get_rays(W, H, intrinsic, c2w, wh_order=True, index=None, center_pixel=False, normalize_rays_d=True):
    """Rays in world coordinates for one camera.

    intrinsic (3, 3), c2w (4, 4) f32 tensors; ``index`` optionally selects
    (N, 2) int (i, j) pixel coords. Returns rays_o (N, 3), rays_d (N, 3),
    index (flat indices or None), rays_r (N, 1) pixel radius (full image
    only, else None).
    """
    dtype, dev = intrinsic.dtype, intrinsic.device
    i, j = torch.meshgrid(torch.arange(W, dtype=dtype, device=dev), torch.arange(H, dtype=dtype, device=dev),
                          indexing="ij")
    pixels = torch.stack([i, j], dim=-1).reshape(-1, 2)  # (WH, 2), wh order
    if center_pixel:
        pixels = pixels + 0.5

    flat_index = None
    if index is not None:
        index = torch.as_tensor(index, device=dev)
        flat_index = index[:, 0].long() * H + index[:, 1].long()
        pixels = pixels[flat_index]
    elif not wh_order:
        pixels = pixels.reshape(W, H, 2).transpose(0, 1).reshape(-1, 2)

    cam_loc = c2w[:3, 3][None]
    rays_d = _pixel_to_world(pixels, intrinsic, c2w) - cam_loc
    rays_o = cam_loc.expand_as(rays_d)

    if normalize_rays_d:
        rays_d = normalize(rays_d)

    rays_r = None
    if flat_index is None:
        if wh_order:
            dirs = rays_d.reshape(W, H, 3)
            dx = torch.sqrt(((dirs[:-1] - dirs[1:]) ** 2).sum(-1))  # (W-1, H)
            dx = torch.cat([dx, dx[-2:-1]], dim=0)
        else:
            dirs = rays_d.reshape(H, W, 3)
            dx = torch.sqrt(((dirs[:, :-1] - dirs[:, 1:]) ** 2).sum(-1))
            dx = torch.cat([dx, dx[:, -2:-1]], dim=1)
        rays_r = (dx[..., None] * 2.0 / 12.0**0.5).reshape(-1, 1)
    return rays_o, rays_d, flat_index, rays_r


def get_near_far_from_rays(rays_o, rays_d, bounds=None, near_hardcode=None, far_hardcode=None, bounding_radius=None):
    """Near/far per ray: hardcode > bounds (optionally sphere-capped) >
    bounding-sphere intersection. Returns near, far each (N_rays, 1)."""
    n_rays = rays_o.shape[0]
    if near_hardcode is None or far_hardcode is None:
        if bounds is None and bounding_radius is None:
            raise NotImplementedError("must specify near/far source")
        if bounds is None:
            near, far, _, _ = sphere_ray_intersection(rays_o, rays_d, radius=float(bounding_radius))
        else:
            near, far = bounds[:, 0:1], bounds[:, 1:2]
            if bounding_radius is not None:
                _, far_bound, _, _ = sphere_ray_intersection(rays_o, rays_d, radius=float(bounding_radius))
                far = torch.minimum(far, far_bound)
        if near_hardcode is not None:
            near = torch.full_like(near, near_hardcode)
        if far_hardcode is not None:
            far = torch.full_like(far, far_hardcode)
    else:
        near = torch.full((n_rays, 1), near_hardcode, dtype=rays_o.dtype, device=rays_o.device)
        far = torch.full((n_rays, 1), far_hardcode, dtype=rays_o.dtype, device=rays_o.device)
    far = torch.where(far <= near, near + 1e-5, far)
    return near, far


def get_zvals_from_near_far(near, far, n_pts, inclusive=True, inverse_linear=False, generator=None, rand=None):
    """Evenly spaced zvals in (near, far), jittered within their intervals
    when a ``generator`` or a uniform ``rand`` is given. near/far
    (N_rays, 1) -> (N_rays, n_pts)."""
    if inclusive:
        t = torch.linspace(0.0, 1.0, n_pts, dtype=near.dtype, device=near.device)
    else:
        t = torch.linspace(0.0, 1.0, n_pts + 2, dtype=near.dtype, device=near.device)[1:-1]
    if inverse_linear:
        zvals = 1.0 / (1.0 / (near + 1e-8) * (1.0 - t) + 1.0 / (far + 1e-8) * t)
    else:
        zvals = near + (far - near) * t
    if generator is not None or rand is not None:
        zvals = perturb_interval(zvals, generator, rand)
    return zvals


def get_zvals_from_near_far_fix_step(near, far, fix_t, n_pts, inclusive=True, generator=None, rand=None):
    """Constant-step zvals clamped at far; duplicated tail points masked out;
    the valid samples jittered when a ``generator`` or a uniform ``rand``
    is given.

    Returns zvals (N_rays, n_pts), mask_pts (N_rays, n_pts).
    """
    assert fix_t > 0
    start = near if inclusive else near + fix_t
    step = torch.arange(n_pts, dtype=near.dtype, device=near.device)[None]
    zvals = torch.minimum(torch.maximum(start + step * fix_t, near), far)
    dup = torch.cat([torch.zeros_like(zvals[:, :1], dtype=torch.bool), (zvals[:, 1:] - zvals[:, :-1]) == 0.0], 1)
    mask_pts = ~dup
    if generator is not None or rand is not None:
        zvals = perturb_interval_with_mask(zvals, mask_pts, generator, rand)
    return zvals, mask_pts


def perturb_interval(vals, generator=None, rand=None):
    """Jitter each sample uniformly within its interval: (B, N) -> (B, N).
    ``rand`` (B, N) uniform draws, else drawn from ``generator``."""
    mids = 0.5 * (vals[..., 1:] + vals[..., :-1])
    upper = torch.cat([mids, vals[..., -1:]], -1)
    lower = torch.cat([vals[..., :1], mids], -1)
    if rand is None:
        rand = torch.rand(upper.shape, generator=generator, dtype=vals.dtype, device=vals.device)
    return lower + (upper - lower) * rand


def perturb_interval_with_mask(vals, mask=None, generator=None, rand=None):
    """Perturb only valid samples; the invalid tail keeps the last valid
    value, and every sample stays within [first, last valid]."""
    perturbed = perturb_interval(vals, generator, rand)
    if mask is None:
        return perturbed
    vals = torch.where(mask, perturbed, vals)
    n_valid = (mask.sum(1) - 1).clamp_min(0)
    last_value = vals.gather(1, n_valid[:, None])
    return torch.minimum(torch.maximum(vals, vals[:, 0:1]), last_value)


def sample_pdf(bins, weights, n_sample, det=False, eps=1e-5, generator=None):
    """Inverse-CDF sampling over weighted bins: bins (B, n_pts), weights
    (B, n_pts - 1) -> (B, n_sample) sorted samples; each weight is raised
    by ``eps`` before the pdf. ``det`` takes evenly spaced u in [0, 1],
    else u is drawn from ``generator``. Each u lands in the bin
    ``searchsorted`` (right) finds in the cdf and is placed linearly inside
    it (a bin of cdf width under ``eps`` counts as 1). No gradient reaches
    the search."""
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    n_pts = bins.shape[-1]
    shape = cdf.shape[:-1] + (n_sample,)
    if det or generator is None:
        u = torch.linspace(0.0, 1.0, n_sample, dtype=bins.dtype, device=bins.device).expand(shape).contiguous()
    else:
        u = torch.rand(shape, generator=generator, dtype=bins.dtype, device=bins.device)
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = (inds - 1).clamp(0, n_pts - 1)
    above = inds.clamp(0, n_pts - 1)
    cdf_lo, cdf_hi = cdf.gather(-1, below), cdf.gather(-1, above)
    bin_lo, bin_hi = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, 1.0, denom)
    t = (u - cdf_lo) / denom
    return torch.sort(bin_lo + t * (bin_hi - bin_lo), -1).values


def alpha_to_weights(alpha):
    """alpha (N_rays, N_p) -> trans_shift (T_i, the transmittance before
    sample i) and weights (T_i * alpha_i), with T_i = prod_{j<i}(1 - alpha_j
    + 1e-10) taken as exp(cumsum(log)) as the JAX package takes it; the log's
    argument is clamped at 1e-10."""
    logt = torch.log(torch.clamp_min(1.0 - alpha + 1e-10, 1e-10))
    csum = torch.cumsum(logt, -1)
    trans_shift = torch.exp(torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], -1))
    return trans_shift, alpha * trans_shift


def scattered_deltas(zvals, mask, inf_tail=False):
    """Marching deltas for a validity mask anywhere on the ladder: delta_j =
    z_{nv(j)} - z_j with nv(j) the next valid slot after j, 0 for invalid
    slots and for the last valid one (1e10 there with ``inf_tail``). zvals
    ascend along each ray, so the next valid z is a reverse cummin of the
    masked z."""
    inf = torch.full_like(zvals[:, :1], torch.inf)
    zm = torch.where(mask, zvals, torch.inf)
    rc = torch.cummin(zm.flip(1), dim=1).values.flip(1)  # min over k >= j
    z_nv = torch.cat([rc[:, 1:], inf], 1)
    has_next = torch.isfinite(z_nv)
    deltas = torch.where(mask & has_next, z_nv - zvals, 0.0)
    deltas = torch.where(deltas.abs() < 1e-5, 0.0, deltas)
    if inf_tail:
        deltas = torch.where(mask & ~has_next, 1e10, deltas)
    return deltas


def ray_marching(sigma, radiance, zvals, add_inf_z=False, noise_std=0.0, white_bkg=False, bkg_color=None,
                 generator=None, mask_pts=None):
    """Alpha compositing along each ray of the dense (N_rays, N_pts) grid.

    alpha_i = 1 - exp(-relu(sigma_i) delta_i), T_i = prod_{j<i}(1 - alpha_j),
    rgb = sum_i T_i alpha_i c_i. With ``add_inf_z`` a 1e10 tail delta keeps all
    N_pts; otherwise the last sample is dropped. With ``mask_pts`` (N_rays,
    N_pts bool) the valid samples may sit anywhere on the ladder: deltas span
    to the next valid sample (``scattered_deltas``), invalid slots get alpha
    0, and all N_pts slots are kept. ``noise_std`` > 0 adds N(0, noise_std)
    to sigma, drawn from ``generator``. ``bkg_color`` (3,) or (N_rays, 3) is
    composited with the last T; else ``white_bkg`` fills 1 - mask.

    Returns rgb (N_rays, 3; None without ``radiance``), depth, mask (N_rays,)
    and sigma, radiance, zvals, alpha, trans_shift, weights at the marching
    length."""
    n_rays = zvals.shape[0]
    _sigma, _radiance, _zvals = sigma, radiance, zvals
    if mask_pts is not None:
        deltas = scattered_deltas(zvals, mask_pts, inf_tail=add_inf_z)
    else:
        deltas = zvals[:, 1:] - zvals[:, :-1]
        deltas = torch.where(deltas.abs() < 1e-5, 0.0, deltas)
        if add_inf_z:
            deltas = torch.cat([deltas, torch.full((n_rays, 1), 1e10, dtype=zvals.dtype, device=zvals.device)], -1)
        else:
            _sigma, _radiance, _zvals = sigma[:, :-1], radiance[:, :-1], zvals[:, :-1]

    noise = 0.0
    if noise_std > 0.0 and generator is not None:
        noise = torch.randn(_sigma.shape, generator=generator, dtype=zvals.dtype, device=zvals.device) * noise_std
    # clamped so that an overflowed density gives alpha 1 and no NaN
    s = torch.clamp_max(torch.relu(_sigma + noise), 1e10)
    alpha = 1.0 - torch.exp(-s * deltas)

    trans_shift, weights = alpha_to_weights(alpha)
    depth = (weights * _zvals).sum(-1)
    mask = weights.sum(-1)
    rgb = None
    if _radiance is not None:
        rgb = (weights[..., None] * _radiance).sum(-2)
        if bkg_color is not None:
            rgb = rgb + trans_shift[:, -1:] * bkg_color
        elif white_bkg:
            rgb = rgb + (1.0 - mask[:, None])
    return {"rgb": rgb, "depth": depth, "mask": mask, "sigma": _sigma, "radiance": _radiance, "zvals": _zvals,
            "alpha": alpha, "trans_shift": trans_shift, "weights": weights}


# Kernel C's lanes a ray (csrc/segment_march.cu): 32 where no per-ray cap
# bounds a segment (training: a few rays carry ~70-180 samples), 8 under the
# serving cap of 16 samples a ray
TRAIN_GROUP, CAPPED_GROUP, CAPPED_MAX = 32, 8, 16


def march_group(cap=None):
    """Kernel C's group width for a stream whose rays hold at most ``cap``
    samples (None or 0: no cap). A ray longer than its group walks more
    chunks, so any width is right; the widths are the fastest measured
    (``design_studies/march_designs.py``)."""
    return CAPPED_GROUP if cap and int(cap) <= CAPPED_MAX else TRAIN_GROUP


def segment_march_reference(sigma, radiance, z, off, cnt, add_inf_z=False, bkg=None, white_bkg=False, alpha=False,
                            tail=None):
    """Plain version of the compositing on the compacted stream.

    Each ray's segment [off, off + cnt) (clipped to the stream) is gathered
    into a (N_rays, max cnt) grid; nothing past a segment is read. Returns
    rgb (N_rays, 3), depth, mask, trans_end (N_rays,). ``bkg`` is a
    (N_rays, 3) background composited with trans_end. With ``alpha`` the
    stream's ``sigma`` holds each sample's alpha (an SDF's sections), which
    is composited as it is: no delta, no relu. ``tail`` (N_rays,), a
    window's (``sample_compact``): a segment's last delta reaches its ray's
    tail z where that is finite (crushed below 1e-5 as the others), as the
    dense march on the pre-cap mask gives it; elsewhere the tail rule
    holds."""
    k_total = sigma.shape[0]
    start = off.clamp_max(k_total)
    n = (off + cnt).clamp_max(k_total) - start  # in-stream samples per ray
    m = max(int(n.max()) if n.numel() else 0, 1)
    pos = torch.arange(m, device=sigma.device)[None]
    inseg = pos < n[:, None]
    idx = torch.where(inseg, start[:, None] + pos, 0)
    zs = torch.where(inseg, z[idx], 0.0)
    z_next = torch.cat([zs[:, 1:], zs[:, -1:]], 1)
    has_next = torch.cat([inseg[:, 1:], torch.zeros_like(inseg[:, :1])], 1)
    deltas = torch.where(has_next, z_next - zs, 0.0)
    last_in = inseg & ~has_next
    if tail is not None:
        has_tail = last_in & torch.isfinite(tail)[:, None]
        deltas = torch.where(has_tail, tail[:, None] - zs, deltas)
        last_in = last_in & ~has_tail
    deltas = torch.where(deltas.abs() < 1e-5, 0.0, deltas)
    if add_inf_z:
        deltas = torch.where(last_in, 1e10, deltas)
    if alpha:
        alpha = torch.where(inseg, sigma[idx], 0.0)
    else:
        s = torch.where(inseg, sigma[idx], 0.0).relu().clamp_max(1e10)
        alpha = torch.where(inseg, 1.0 - torch.exp(-s * deltas), 0.0)
    one_m_alpha = 1.0 - alpha + 1e-10
    trans_incl = torch.cumprod(one_m_alpha, dim=1)
    trans = torch.cat([torch.ones_like(trans_incl[:, :1]), trans_incl[:, :-1]], 1)
    weights = trans * alpha
    mask = weights.sum(1)
    depth = (weights * zs).sum(1)
    rgb = (weights[..., None] * torch.where(inseg[..., None], radiance[idx], 0.0)).sum(1)
    last = (n - 1).clamp_min(0)
    trans_end = torch.where(cnt > 0, trans_incl.gather(1, last[:, None])[:, 0], 1.0)
    if bkg is not None:
        rgb = rgb + trans_end[:, None] * bkg
    elif white_bkg:
        rgb = rgb + (1.0 - mask[:, None])
    return {"rgb": rgb, "depth": depth, "mask": mask, "trans_end": trans_end}


def segment_march_bwd_reference(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z=False, bkg=None,
                                white_bkg=False, alpha=False):
    """Plain version of the gradient of the compositing with respect to
    sigma (K,) and radiance (K, 3), given those of rgb (N_rays, 3), depth and
    mask (N_rays,). The same recurrence as kernel F, walked over the
    columns of the gathered (N_rays, max cnt) grid: with o_i = 1 - alpha_i
    + 1e-10, T_i the exclusive transmittance and G_i = dM + z_i dD + c_i . dRGB
    (minus sum(dRGB) under ``white_bkg``), R starts at bkg . dRGB and goes
    back as R <- alpha_i G_i + o_i R; dalpha_i = T_i (G_i - R_i). Rows past
    every segment get 0. With ``alpha`` the first gradient is dalpha
    itself (``sigma`` holds alpha)."""
    k_total = sigma.shape[0]
    start = off.clamp_max(k_total)
    n = (off + cnt).clamp_max(k_total) - start
    m = max(int(n.max()) if n.numel() else 0, 1)
    pos = torch.arange(m, device=sigma.device)[None]
    inseg = pos < n[:, None]
    idx = torch.where(inseg, start[:, None] + pos, 0)
    zs = torch.where(inseg, z[idx], 0.0)
    z_next = torch.cat([zs[:, 1:], zs[:, -1:]], 1)
    has_next = torch.cat([inseg[:, 1:], torch.zeros_like(inseg[:, :1])], 1)
    deltas = torch.where(has_next, z_next - zs, 0.0)
    deltas = torch.where(deltas.abs() < 1e-5, 0.0, deltas)
    if add_inf_z:
        deltas = torch.where(inseg & ~has_next, 1e10, deltas)
    s_raw = torch.where(inseg, sigma[idx], 0.0)
    alpha_mode = alpha
    ex = torch.exp(-s_raw.relu().clamp_max(1e10) * deltas)
    alpha = s_raw if alpha_mode else torch.where(inseg, 1.0 - ex, 0.0)
    o = 1.0 - alpha + 1e-10
    trans = torch.cat([torch.ones_like(o[:, :1]), torch.cumprod(o, dim=1)[:, :-1]], 1)
    c = torch.where(inseg[..., None], radiance[idx], 0.0)
    G = g_mask[:, None] + zs * g_depth[:, None] + (c * g_rgb[:, None, :]).sum(-1)
    if bkg is not None:
        R = (bkg * g_rgb).sum(-1)
    else:
        R = torch.zeros_like(g_mask)
        if white_bkg:
            G = G - g_rgb.sum(-1, keepdim=True)
    d_alpha = torch.zeros_like(alpha)
    for j in reversed(range(m)):
        d_alpha[:, j] = trans[:, j] * (G[:, j] - R)
        R = torch.where(inseg[:, j], alpha[:, j] * G[:, j] + o[:, j] * R, R)
    if alpha_mode:
        d_s = torch.where(inseg, d_alpha, 0.0)
    else:
        active = inseg & (s_raw > 0) & (s_raw < 1e10)
        d_s = torch.where(active, d_alpha * deltas * ex, 0.0)
    ray = torch.arange(off.shape[0], device=sigma.device)[:, None].expand_as(idx)
    d_sigma = torch.zeros_like(sigma)
    d_sigma[idx[inseg]] = d_s[inseg]
    d_rgb = torch.zeros_like(radiance)
    d_rgb[idx[inseg]] = (trans * alpha)[inseg][:, None] * g_rgb[ray[inseg]]
    return d_sigma, d_rgb


def segment_march_fwd(sigma, radiance, z, off, cnt, add_inf_z=False, bkg=None, white_bkg=False, group=TRAIN_GROUP,
                      alpha=False, tail=None):
    """Kernel C on CUDA tensors -> {rgb, depth, mask, trans_end}, or raises;
    ``group`` lanes a ray (32 or 8, see ``march_group``); ``alpha``: the
    stream holds alpha in place of sigma; ``tail`` (N_rays,) or None: a
    window's tails (C's tail mode, see ``segment_march_reference``)."""
    tail_args = {} if tail is None else {"tail": tail}
    rgb, depth, mask, trans_end = cuda_lib.ops().segment_march_fwd(sigma, radiance, z, off, cnt, bool(add_inf_z), bkg,
                                                                   bool(white_bkg), int(group), bool(alpha),
                                                                   **tail_args)
    if off.shape[0] > 0:
        segment_march.launches += 1
    return {"rgb": rgb, "depth": depth, "mask": mask, "trans_end": trans_end}


def segment_march_bwd(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z=False, bkg=None,
                      white_bkg=False, alpha=False):
    """Gradients (d_sigma (K,), d_radiance (K, 3)) of the compositing. A CPU
    tensor takes ``segment_march_bwd_reference``; a CUDA tensor launches
    kernel F or raises."""
    if z.is_cpu:
        return segment_march_bwd_reference(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z, bkg,
                                           white_bkg, alpha)
    d_sigma, d_rgb = cuda_lib.ops().segment_march_bwd(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask,
                                                      bool(add_inf_z), bkg, bool(white_bkg), bool(alpha))
    if off.shape[0] > 0:
        segment_march_bwd.launches += 1
    return d_sigma, d_rgb


class _SegmentMarchFunction(torch.autograd.Function):
    """Compositing with its sigma/radiance gradient: kernels C and F on the
    card, their plain versions on the CPU. trans_end carries no gradient."""

    @staticmethod
    def forward(ctx, sigma, radiance, z, off, cnt, bkg, add_inf_z, white_bkg, group, alpha=False):
        if z.is_cpu:
            out = segment_march_reference(sigma, radiance, z, off, cnt, add_inf_z, bkg, white_bkg, alpha)
        else:
            out = segment_march_fwd(sigma, radiance, z, off, cnt, add_inf_z, bkg, white_bkg, group, alpha)
        ctx.save_for_backward(sigma, radiance, z, off, cnt, bkg)
        ctx.flags = (add_inf_z, white_bkg, alpha)
        ctx.mark_non_differentiable(out["trans_end"])
        return out["rgb"], out["depth"], out["mask"], out["trans_end"]

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_mask, _g_trans_end):
        sigma, radiance, z, off, cnt, bkg = ctx.saved_tensors
        n_rays = off.shape[0]
        g_rgb = torch.zeros((n_rays, 3), device=z.device) if g_rgb is None else g_rgb.contiguous()
        g_depth = torch.zeros((n_rays,), device=z.device) if g_depth is None else g_depth.contiguous()
        g_mask = torch.zeros((n_rays,), device=z.device) if g_mask is None else g_mask.contiguous()
        add_inf_z, white_bkg, alpha = ctx.flags
        d_sigma, d_rgb = segment_march_bwd(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z, bkg,
                                           white_bkg, alpha=alpha)
        return d_sigma, d_rgb, None, None, None, None, None, None, None, None


def segment_march(sigma, radiance, z, off, cnt, add_inf_z=False, white_bkg=False, bkg_color=None, noise=None,
                  group=TRAIN_GROUP, alpha=False, tail=None):
    """Alpha compositing over a COMPACTED sample stream.

    sigma (K,), radiance (K, 3), z (K,) hold the stream (first sum(cnt)
    rows real, the tail is budget padding whose ray is arbitrary); off
    (N_rays,) is each ray's unclipped exclusive start rank and cnt (N_rays,)
    its in-stream sample count. ``bkg_color`` (3,) or (N_rays, 3) is
    composited with the end transmittance; else ``white_bkg`` fills
    1 - mask. ``noise`` (K,) is added to sigma first (the JAX ``noise``,
    pre-drawn). With ``alpha`` the stream's ``sigma`` holds alpha (an SDF's
    sections; kernels C and F in their alpha mode). ``tail`` (N_rays,): a
    window's tails (kernel C's tail mode; inference only, no gradient).

    A CPU tensor takes the plain versions; a CUDA tensor launches kernel C
    on ``group`` lanes a ray (``march_group``), and kernel F in the
    backward, or raises. Returns rgb (N_rays, 3), depth, mask, trans_end."""
    n_rays = off.shape[0]
    bkg = None
    if bkg_color is not None:
        bkg = torch.as_tensor(bkg_color, dtype=torch.float32, device=z.device).expand(n_rays, 3).contiguous()
    if noise is not None:
        sigma = sigma + noise
    if not (z.is_cpu or z.is_cuda):  # the binding checks the rest; this spares a build
        raise ValueError("segment_march: expected CPU or CUDA tensors, got {}".format(z.device))
    if torch.is_grad_enabled() and (sigma.requires_grad or radiance.requires_grad):
        if tail is not None:
            raise NotImplementedError("segment_march: a window's tail marches at inference only")
        rgb, depth, mask, trans_end = _SegmentMarchFunction.apply(sigma.contiguous(), radiance.contiguous(), z, off,
                                                                  cnt, bkg, add_inf_z, white_bkg, group, alpha)
        return {"rgb": rgb, "depth": depth, "mask": mask, "trans_end": trans_end}
    if z.is_cpu:
        return segment_march_reference(sigma, radiance, z, off, cnt, add_inf_z, bkg, white_bkg, alpha, tail)
    return segment_march_fwd(sigma, radiance, z, off, cnt, add_inf_z, bkg, white_bkg, group, alpha, tail)


segment_march.launches = 0
segment_march_bwd.launches = 0
