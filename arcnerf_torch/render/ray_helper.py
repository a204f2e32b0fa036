"""Ray generation, z-value sampling, and compositing on the compacted stream
with kernel C.

Counterpart of ``arcnerf_tpu/render/ray_helper.py`` (get_rays,
get_near_far_from_rays, get_zvals_from_near_far,
get_zvals_from_near_far_fix_step, segment_march). ``segment_march``
replaces the JAX scan-and-cumsum formulation with the CUDA kernel in
``csrc/segment_march.cu``; ``segment_march_reference`` is the plain
version. Only the deterministic (inference) forms are ported: no sample
jitter, no random ray picks, no NDC rays.
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


def get_zvals_from_near_far(near, far, n_pts, inclusive=True, inverse_linear=False):
    """Evenly spaced zvals in (near, far). near/far (N_rays, 1) -> (N_rays, n_pts)."""
    if inclusive:
        t = torch.linspace(0.0, 1.0, n_pts, dtype=near.dtype, device=near.device)
    else:
        t = torch.linspace(0.0, 1.0, n_pts + 2, dtype=near.dtype, device=near.device)[1:-1]
    if inverse_linear:
        zvals = 1.0 / (1.0 / (near + 1e-8) * (1.0 - t) + 1.0 / (far + 1e-8) * t)
    else:
        zvals = near + (far - near) * t
    return zvals


def get_zvals_from_near_far_fix_step(near, far, fix_t, n_pts, inclusive=True):
    """Constant-step zvals clamped at far; duplicated tail points masked out.

    Returns zvals (N_rays, n_pts), mask_pts (N_rays, n_pts).
    """
    assert fix_t > 0
    start = near if inclusive else near + fix_t
    step = torch.arange(n_pts, dtype=near.dtype, device=near.device)[None]
    zvals = torch.minimum(torch.maximum(start + step * fix_t, near), far)
    dup = torch.cat([torch.zeros_like(zvals[:, :1], dtype=torch.bool), (zvals[:, 1:] - zvals[:, :-1]) == 0.0], 1)
    return zvals, ~dup


def segment_march_reference(sigma, radiance, z, off, cnt, add_inf_z=False, bkg=None, white_bkg=False):
    """Plain version of the compositing on the compacted stream.

    Each ray's segment [off, off + cnt) (clipped to the stream) is gathered
    into a (N_rays, max cnt) grid; nothing past a segment is read. Returns
    rgb (N_rays, 3), depth, mask, trans_end (N_rays,). ``bkg`` is a
    (N_rays, 3) background composited with trans_end."""
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
    deltas = torch.where(deltas.abs() < 1e-5, 0.0, deltas)
    if add_inf_z:
        deltas = torch.where(inseg & ~has_next, 1e10, deltas)
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


def segment_march(sigma, radiance, z, off, cnt, add_inf_z=False, white_bkg=False, bkg_color=None):
    """Alpha compositing over a COMPACTED sample stream.

    sigma (K,), radiance (K, 3), z (K,) hold the stream (first sum(cnt)
    rows real, the tail is budget padding whose ray is arbitrary); off
    (N_rays,) is each ray's unclipped exclusive start rank and cnt (N_rays,)
    its in-stream sample count. ``bkg_color`` (3,) or (N_rays, 3) is
    composited with the end transmittance; else ``white_bkg`` fills
    1 - mask.

    A CPU tensor takes ``segment_march_reference``; a CUDA tensor launches
    kernel C or raises. Returns rgb (N_rays, 3), depth, mask, trans_end."""
    n_rays = off.shape[0]
    bkg = None
    if bkg_color is not None:
        bkg = torch.as_tensor(bkg_color, dtype=torch.float32, device=z.device).expand(n_rays, 3).contiguous()
    if z.device.type == "cpu":
        return segment_march_reference(sigma, radiance, z, off, cnt, add_inf_z, bkg, white_bkg)
    cuda_lib.require_cuda("segment_march", sigma, radiance, z)
    if torch.is_grad_enabled() and (sigma.requires_grad or radiance.requires_grad):
        raise RuntimeError("segment_march: the CUDA backward kernel is not ported yet (inference only)")
    cuda_lib.require_cuda("segment_march", off, cnt, dtype=torch.int64)
    out = {
        "rgb": torch.empty((n_rays, 3), dtype=torch.float32, device=z.device),
        "depth": torch.empty((n_rays,), dtype=torch.float32, device=z.device),
        "mask": torch.empty((n_rays,), dtype=torch.float32, device=z.device),
        "trans_end": torch.empty((n_rays,), dtype=torch.float32, device=z.device),
    }
    if n_rays == 0:
        return out
    status = cuda_lib.lib().arcnerf_segment_march_fwd(
        sigma.data_ptr(), radiance.data_ptr(), z.data_ptr(), off.data_ptr(), cnt.data_ptr(), n_rays, z.shape[0],
        int(bool(add_inf_z)), bkg.data_ptr() if bkg is not None else None, int(bool(white_bkg)),
        out["rgb"].data_ptr(), out["depth"].data_ptr(), out["mask"].data_ptr(), out["trans_end"].data_ptr(),
        cuda_lib.stream_handle(z.device))
    cuda_lib.check(status, "segment_march")
    segment_march.launches += 1
    return out


segment_march.launches = 0
