"""Rays and occupancy for the fused sampler (``sample_compact``), made with
numpy from a seed: the cases its tests and timings hold it to, at the main
path's shapes or at any smaller size.

- ``ladder_volume``: the NGP recipe's volume (128^3 voxels, side 2);
- ``ladder_bitfield``: the benchmark scene's occupancy (``scene``, ~6 % of
  the voxels, as a trained grid converges to), ``empty``, ``full`` or
  ``half`` (each voxel occupied with probability 1/2, which overflows a
  training step's budget);
- ``ladder_rays``: cameras 2.5-4 from the centre, each ray aimed at a point
  of the volume, a ``miss_frac`` share turned away from it, one in twenty
  parallel to one axis's slabs.
"""

import numpy as np
import torch

from ..datasets.synthetic_dataset import sphere_scene_bitfield
from ..geometry.volume import Volume

BITFIELDS = ("scene", "empty", "full", "half")


def ladder_volume(n_grid=128, side=2.0):
    return Volume(n_grid=n_grid, side=side)


def ladder_bitfield(kind, volume, seed, device="cpu"):
    """(n, n, n) bool occupancy of ``kind`` (BITFIELDS) on ``device``."""
    n = volume.get_n_grid()
    if kind == "scene":
        occ = sphere_scene_bitfield(n, float(volume.xyz_len[0]))
    elif kind == "half":
        occ = np.random.default_rng(seed).random((n, n, n)) < 0.5
    else:
        occ = np.full((n, n, n), kind == "full")
    return torch.from_numpy(occ).to(device)


def ladder_rays(volume, n_rays, seed, miss_frac=0.1, device="cpu"):
    """(rays_o, rays_d): (n_rays, 3) f32 unit rays."""
    rng = np.random.default_rng(seed)
    cam = rng.normal(size=(n_rays, 3))
    cam *= rng.uniform(2.5, 4.0, size=(n_rays, 1)) / np.linalg.norm(cam, axis=1, keepdims=True)
    half = volume.xyz_len / 2.0
    target = rng.uniform(-half, half, size=(n_rays, 3))
    dirs = target - cam
    away = rng.random(n_rays) < miss_frac
    dirs[away] = cam[away]  # outward from the centre: misses the volume
    flat = rng.random(n_rays) < 0.05  # parallel to one axis's slabs: inside or outside them
    dirs[flat, rng.integers(0, 3, size=int(flat.sum()))] = 0.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays_o = torch.from_numpy(cam.astype(np.float32)).to(device)
    rays_d = torch.from_numpy(dirs.astype(np.float32)).to(device)
    return rays_o, rays_d


def ladder_rand(n_rays, n_pts, seed, device="cpu"):
    """(n_rays, n_pts) f32 uniform jitter draws."""
    return torch.from_numpy(np.random.default_rng(seed).random((n_rays, n_pts), dtype=np.float32)).to(device)
