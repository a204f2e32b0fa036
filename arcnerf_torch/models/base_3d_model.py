"""Base 3d model: shared ray cfgs and the per-point net query.

Counterpart of the parts of ``arcnerf_tpu/models/base_3d_model.py`` that
the compacted render path uses. Occupancy state is an explicit
``bound_state`` argument.
"""

from torch import nn

from ..utils.cfgs import get_value_from_cfgs_field


class Base3dModel(nn.Module):
    """Shared base for fg/bkg 3d models."""

    def __init__(self, cfgs):
        super().__init__()
        self.cfgs = cfgs

    def read_ray_cfgs(self):
        rays = self.cfgs.model.rays
        return {
            "bounding_radius": get_value_from_cfgs_field(rays, "bounding_radius"),
            "near": get_value_from_cfgs_field(rays, "near"),
            "far": get_value_from_cfgs_field(rays, "far"),
            "n_sample": get_value_from_cfgs_field(rays, "n_sample", 128),
            "inverse_linear": get_value_from_cfgs_field(rays, "inverse_linear", False),
            "add_inf_z": get_value_from_cfgs_field(rays, "add_inf_z", False),
            "white_bkg": get_value_from_cfgs_field(rays, "white_bkg", False),
            "n_importance": get_value_from_cfgs_field(rays, "n_importance", 0),
        }

    def get_ray_cfgs(self, key=None):
        cfgs = self.read_ray_cfgs()
        return cfgs if key is None else cfgs[key]

    @staticmethod
    def sigma_reverse():
        """True for sdf-style models where inside-object geo value < 0."""
        return False

    @staticmethod
    def _forward_pts_dir(geo_net, radiance_net, pts, rays_d):
        """(B, 3), (B, 3) -> sigma (B,), radiance (B, 3)."""
        geo, feat = geo_net(pts)
        radiance = radiance_net(pts, rays_d, None, feat)
        return geo[..., 0], radiance
