"""Ray geometry: points on rays, ray/sphere and ray/AABB intersection.

Counterpart of ``get_ray_points_by_zvals``, ``sphere_ray_intersection`` and
``aabb_ray_intersection`` in ``arcnerf_tpu/geometry/ray.py``.
"""

import torch

_ZERO_EPS = 1e-6  # snap tiny values to zero


def _set_small_to_zero(x, eps=_ZERO_EPS):
    return torch.where(x.abs() < eps, torch.zeros_like(x), x)


def get_ray_points_by_zvals(rays_o, rays_d, zvals):
    """(N_rays, 3), (N_rays, 3), (N_rays, N_pts) -> (N_rays, N_pts, 3)."""
    return rays_o[:, None, :] + rays_d[:, None, :] * zvals[..., None]


def sphere_ray_intersection(rays_o, rays_d, radius, origin=(0.0, 0.0, 0.0)):
    """Ray/sphere near-far intersection.

    rays (N_rays, 3); radius scalar or (N_r,); one shared origin.
    Returns near (N_rays, N_r), far (N_rays, N_r), pts (N_rays, N_r, 2, 3),
    mask (N_rays, N_r). Near/far clamped to >= 0; misses give near = far = 0
    and mask False.
    """
    radius = torch.atleast_1d(torch.as_tensor(radius, dtype=rays_o.dtype, device=rays_o.device))
    c = torch.as_tensor(origin, dtype=rays_o.dtype, device=rays_o.device)
    oc = c[None, :] - rays_o  # (N_rays, 3)
    z_half = _set_small_to_zero((oc * rays_d).sum(-1))[:, None]  # (N_rays, 1)
    inside = torch.linalg.vector_norm(oc, dim=-1, keepdim=True) <= radius[None, :]
    mask = (z_half > 0) | inside
    d2 = _set_small_to_zero((oc * oc).sum(-1, keepdim=True) - z_half**2)
    mask = mask & (d2 >= 0)
    z_offset2 = _set_small_to_zero(radius[None, :] ** 2 - d2)
    mask = mask & (z_offset2 >= 0)
    z_offset = torch.sqrt(z_offset2.clamp_min(0.0))
    near = torch.where(mask, (z_half - z_offset).clamp_min(0.0), 0.0)
    far = torch.where(mask, (z_half + z_offset).clamp_min(0.0), 0.0)
    zvals = torch.stack([near, far], dim=-1)  # (N_rays, N_r, 2)
    pts = rays_o[:, None, None, :] + rays_d[:, None, None, :] * zvals[..., None]
    return near, far, pts, mask


def aabb_ray_intersection(rays_o, rays_d, aabb_range, eps=1e-7):
    """Ray/AABB slab-test intersection against N_v boxes.

    rays (N_rays, 3); aabb_range (N_v, 3, 2) xyz min/max.
    Returns near/far (N_rays, N_v), pts (N_rays, N_v, 2, 3), mask (N_rays, N_v):
    clamped >= 0, plus/minus eps inset on hits, zeros on miss.
    """
    mn = aabb_range[None, :, :, 0]  # (1, N_v, 3)
    mx = aabb_range[None, :, :, 1]
    o = rays_o[:, None, :]  # (N_rays, 1, 3)
    d = rays_d[:, None, :]

    parallel = d.abs() < eps
    out_slab = (o < mn) | (o > mx)
    miss_parallel = (parallel & out_slab).any(dim=-1)  # (N_rays, N_v)

    safe_d = torch.where(parallel, torch.ones_like(d), d)
    t1 = (mn - o) / safe_d
    t2 = (mx - o) / safe_d
    t_near = torch.where(parallel, -torch.inf, torch.minimum(t1, t2))
    t_far = torch.where(parallel, torch.inf, torch.maximum(t1, t2))
    near_raw = t_near.amax(dim=-1)  # (N_rays, N_v)
    far_raw = t_far.amin(dim=-1)
    near = near_raw.clamp_min(0.0)
    far = far_raw.clamp_min(0.0)

    mask = (~miss_parallel) & (near_raw <= far_raw) & (far_raw >= 0)
    near = torch.where(mask, near + eps, 0.0)
    far = torch.where(mask, far - eps, 0.0)

    zvals = torch.stack([near, far], dim=-1)  # (N_rays, N_v, 2)
    pts = rays_o[:, None, None, :] + rays_d[:, None, None, :] * zvals[..., None]
    return near, far, pts, mask
