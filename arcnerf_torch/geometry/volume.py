"""Dense voxel volume: static geometry plus occupancy lookups.

Counterpart of the ``Volume`` class of ``arcnerf_tpu/geometry/volume.py``,
reduced to what the NGP recipe's serving and training need: range, voxel
size and diagonal, the bitfield/opacity-field constructors and updates,
the flat <-> xyz voxel index, voxel centres, the per-axis flat voxel index,
the flat-take occupancy test and the ray/volume intersection. ``Volume``
holds only static geometry; the bitfield and the opacity field are passed
in and out explicitly.
"""

import numpy as np
import torch

from ..utils.device_consts import device_constant
from .ray import aabb_ray_intersection


def convert_flatten_index_to_xyz_index(flat, n):
    """(B,) flat voxel index -> (B, 3) xyz index (flat = x*n^2 + y*n + z)."""
    return torch.stack([flat // (n * n), (flat // n) % n, flat % n], dim=-1)


class Volume:
    """Axis-aligned voxel volume centered at ``origin`` with ``n_grid``
    voxels per side."""

    def __init__(self, n_grid=None, origin=(0, 0, 0), side=None, xyz_len=None, **kwargs):
        self.n_grid = n_grid
        self.origin = np.zeros(3, dtype=np.float32)
        self.xyz_len = np.zeros(3, dtype=np.float32)
        if origin is not None and (side is not None or xyz_len is not None):
            self.set_params(origin, side, xyz_len)

    def set_params(self, origin, side, xyz_len):
        assert side is not None or xyz_len is not None, "specify side or xyz_len"
        self.origin = np.asarray(origin, dtype=np.float32)
        if side is not None:
            self.xyz_len = np.array([side, side, side], dtype=np.float32)
        else:
            self.xyz_len = np.asarray(xyz_len, dtype=np.float32)

    # --------------------------------------------------------------- geometry
    def get_n_grid(self):
        return self.n_grid

    def get_n_voxel(self):
        return self.n_grid**3

    def get_range_np(self):
        """np (3, 2) min/max per axis."""
        half = self.xyz_len / 2.0
        return np.stack([self.origin - half, self.origin + half], axis=-1)

    def get_range(self, device=None):
        """(3, 2) min/max per axis as an f32 tensor (made once a device)."""
        return device_constant(self.get_range_np(), device=device)

    def get_diag_len(self):
        return float(np.linalg.norm(self.xyz_len))

    def get_voxel_size(self, to_list=True, device=None):
        """Voxel side lengths: three floats, or an f32 (3,) tensor (made
        once a device)."""
        xyz_s = self.xyz_len / self.n_grid
        if to_list:
            return float(xyz_s[0]), float(xyz_s[1]), float(xyz_s[2])
        return device_constant(xyz_s, device=device)

    def get_voxel_pts_by_voxel_idx(self, voxel_idx):
        """(B, 3) xyz voxel index -> (B, 3) voxel centres."""
        vs = self.get_voxel_size(to_list=False, device=voxel_idx.device)
        start = self.get_range(voxel_idx.device)[:, 0]
        return voxel_idx.to(torch.float32) * vs + 0.5 * vs + start

    # ---------------------------------------------------------------- state
    def create_bitfield(self, init_occ=True, device=None):
        """-> (n_grid, n_grid, n_grid) bool tensor (caller owns the state)."""
        fn = torch.ones if init_occ else torch.zeros
        return fn((self.n_grid,) * 3, dtype=torch.bool, device=device)

    def create_opafield(self, init=0.0, device=None):
        """-> (n_grid, n_grid, n_grid) f32 opacity field."""
        return torch.full((self.n_grid,) * 3, init, dtype=torch.float32, device=device)

    @staticmethod
    def update_bitfield(bitfield, occupancy, ops="and"):
        """Combine new occupancy into the bitfield; returns the new bitfield."""
        occupancy = occupancy.reshape(bitfield.shape)
        if ops == "and":
            return bitfield & occupancy
        if ops == "or":
            return bitfield | occupancy
        if ops == "overwrite":
            return occupancy
        raise NotImplementedError("ops {} not supported".format(ops))

    @staticmethod
    def get_mean_voxel_opacity(opafield):
        return opafield.clamp_min(0.0).mean()

    def update_bitfield_by_opafield(self, bitfield, opafield, threshold=0.01, ops="and"):
        """Occupancy = opacity >= min(mean opacity, threshold)."""
        thres = torch.clamp_max(self.get_mean_voxel_opacity(opafield), threshold)
        return self.update_bitfield(bitfield, opafield >= thres, ops)

    # -------------------------------------------------------------- indexing
    def get_flat_voxel_idx_from_coords(self, x, y, z):
        """Per-axis coords (any same shape) -> (flat voxel idx, valid).
        Indices truncate toward zero; ``valid`` (all of fx, fy, fz in
        [0, n)) is what makes that equal to floor where it matters."""
        vs = self.get_voxel_size()
        start = self.get_range_np()[:, 0]
        n = self.n_grid
        fx = (x - float(start[0])) / vs[0]
        fy = (y - float(start[1])) / vs[1]
        fz = (z - float(start[2])) / vs[2]
        valid = (fx >= 0) & (fx < n) & (fy >= 0) & (fy < n) & (fz >= 0) & (fz < n)
        ix = fx.to(torch.int32).clamp(0, n - 1)
        iy = fy.to(torch.int32).clamp(0, n - 1)
        iz = fz.to(torch.int32).clamp(0, n - 1)
        return (ix * n + iy) * n + iz, valid

    @staticmethod
    def check_flat_in_occ_voxel(flat_idx, valid, bitfield):
        """Occupancy lookup by flat voxel index (flat take); returns
        valid & occupied."""
        occ = bitfield.reshape(-1)[flat_idx.reshape(-1).long()].reshape(flat_idx.shape)
        return valid & occ

    # ------------------------------------------------------------ intersection
    def ray_volume_intersection(self, rays_o, rays_d):
        """Ray/volume near-far against the full volume AABB.

        Returns near (N, 1), far (N, 1), pts (N, 2, 3), mask (N, 1).
        """
        aabb = self.get_range(rays_o.device)[None]
        near, far, pts, mask = aabb_ray_intersection(rays_o, rays_d, aabb)
        return near, far, pts[:, 0], mask
