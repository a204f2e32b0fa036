"""The benchmark's own copy of the sphere scene: four lambertian spheres in
the unit volume, cameras that look at its centre, their rays, exact ray
tracing of the scene, and the occupancy grid a trained model converges to.
All in torch on one device; the program receives only what is made here.
"""

import math

import torch

# (centre, radius, rgb)
SPHERES = (
    ((0.0, 0.15, 0.0), 0.42, (0.85, 0.25, 0.2)),
    ((0.45, -0.25, 0.1), 0.22, (0.2, 0.7, 0.3)),
    ((-0.4, -0.3, -0.15), 0.25, (0.25, 0.35, 0.85)),
    ((0.05, -0.32, -0.45), 0.18, (0.9, 0.8, 0.2)),
)
LIGHT = (0.5, -0.8, 0.3)
FOCAL_RATIO = 1.2  # focal length over image width


def sphere_point(u, v, radius):
    """Azimuth u and polar angle v (from +y, the up axis) -> (n, 3)."""
    return torch.stack([radius * torch.cos(u) * torch.sin(v), radius * torch.cos(v),
                        radius * torch.sin(u) * torch.sin(v)], -1)


def look_at(cam):
    """(n, 3) camera centres -> (n, 3, 4) camera-to-world (x, y, z, t)
    looking at the origin along +z, y up."""
    fwd = -cam / torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=cam.dtype, device=cam.device).expand_as(fwd)
    x = torch.linalg.cross(up, fwd)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(fwd, x)
    return torch.stack([x, y, fwd, cam], -1)


def camera_rays(c2w, width, height):
    """Pixel-centre rays of one camera in row-major pixel order:
    rays_o, unit rays_d (H W, 3) f32."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=dev),
                          torch.arange(width, dtype=torch.float64, device=dev), indexing="ij")
    focal = FOCAL_RATIO * width
    cam = torch.stack([(i + 0.5 - width / 2.0) / focal, (j + 0.5 - height / 2.0) / focal, torch.ones_like(i)], -1)
    d = cam.reshape(-1, 3) @ c2w[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = c2w[:, 3].expand_as(d)
    return o.float().contiguous(), d.float().contiguous()


def trace(rays_o, rays_d):
    """Exact render of the scene over white: rgb (n, 3) and coverage mask
    (n,) f32."""
    o, d = rays_o.double(), rays_d.double()
    light = torch.tensor(LIGHT, dtype=torch.float64, device=o.device)
    light = light / torch.linalg.vector_norm(light)
    best = torch.full(o.shape[:1], torch.inf, dtype=torch.float64, device=o.device)
    rgb = torch.ones_like(o)
    for centre, radius, color in SPHERES:
        c = torch.tensor(centre, dtype=torch.float64, device=o.device)
        oc = c - o
        b = (oc * d).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - radius * radius)
        sq = disc.clamp_min(0.0).sqrt()
        t = torch.where(b - sq > 1e-3, b - sq, b + sq)
        hit = (disc > 0) & (t > 1e-3) & (t < best)
        normal = (o + d * t[:, None] - c) / radius
        lam = 0.35 + 0.65 * (-(normal * light).sum(-1)).clamp_min(0.0)
        shaded = torch.tensor(color, dtype=torch.float64, device=o.device) * lam[:, None]
        rgb = torch.where(hit[:, None], shaded, rgb)
        best = torch.where(hit, t, best)
    return rgb.clamp(0.0, 1.0).float(), torch.isfinite(best).float()


def bitfield(n_grid, side):
    """(n, n, n) bool, flat index x n^2 + y n + z: the voxels whose centre
    lies inside a sphere grown by half a voxel diagonal."""
    vs = side / n_grid
    axis = (torch.arange(n_grid, dtype=torch.float64) + 0.5) * vs - side / 2.0
    pts = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
    occ = torch.zeros((n_grid,) * 3, dtype=torch.bool)
    for centre, radius, _ in SPHERES:
        dist = torch.linalg.vector_norm(pts - torch.tensor(centre, dtype=torch.float64), dim=-1)
        occ |= dist <= radius + 0.5 * math.sqrt(3.0) * vs
    return occ
