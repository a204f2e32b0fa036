"""Base 3d model: shared ray cfgs, the dense ray-marching wrapper, the
progress outputs and the per-point net queries.

Counterpart of ``arcnerf_tpu/models/base_3d_model.py`` (ray cfgs,
``ray_marching_wrap``, ``output_get_progress``, ``adjust_coarse_fine_output``,
``_forward_pts_dir``, ``forward_pts_dir``, ``forward_pts``,
``get_est_opacity``); surface rendering waits for the SDF models. Occupancy
state is an explicit ``bound_state`` argument, and the training draws come
from a ``torch.Generator``.
"""

import torch
from torch import nn

from ..geometry.transformation import normalize
from ..render.ray_helper import ray_marching
from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field

PROGRESS_KEYS = ("sigma", "zvals", "alpha", "trans_shift", "weights", "radiance")


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
            "perturb": get_value_from_cfgs_field(rays, "perturb", False),
            "add_inf_z": get_value_from_cfgs_field(rays, "add_inf_z", False),
            "noise_std": get_value_from_cfgs_field(rays, "noise_std", 0.0),
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

    # --------------------------------------------------------- ray marching
    def ray_marching_wrap(self, sigma, radiance, zvals, add_inf_z=None, inference_only=False, bkg_color=None,
                          mask_pts=None, generator=None):
        """``ray_marching`` with the model's add_inf_z, noise_std (training
        only, drawn from ``generator``) and white_bkg; ``mask_pts`` selects
        the scattered-mask mode."""
        noise_std = 0.0 if inference_only else float(self.get_ray_cfgs("noise_std") or 0.0)
        return ray_marching(sigma, radiance, zvals, self.get_ray_cfgs("add_inf_z") if add_inf_z is None else add_inf_z,
                            noise_std, white_bkg=self.get_ray_cfgs("white_bkg"), bkg_color=bkg_color,
                            generator=generator, mask_pts=mask_pts)

    @staticmethod
    def output_get_progress(output, get_progress=False):
        """Keep the per-sample marching tensors as progress_* keys when
        ``get_progress``; drop them from ``output`` either way."""
        for key in PROGRESS_KEYS:
            v = output.pop(key, None)
            if get_progress and v is not None:
                output["progress_{}".format(key)] = v
        return output

    def adjust_coarse_fine_output(self, output, inference_only=False):
        """{'coarse': ..., 'fine': ...} stage dicts -> one dict: the last
        stage's plain keys at inference, else keys suffixed _coarse/_fine."""
        if inference_only:
            return output["fine"] if self.get_ray_cfgs("n_importance") > 0 else output["coarse"]
        out = {"{}_coarse".format(k): v for k, v in output["coarse"].items()}
        if self.get_ray_cfgs("n_importance") > 0:
            out.update({"{}_fine".format(k): v for k, v in output["fine"].items()})
        return out

    # ---------------------------------------------------------- pts forward
    @staticmethod
    def _forward_pts_dir(geo_net, radiance_net, pts, rays_d):
        """(B, 3), (B, 3) -> sigma (B,), radiance (B, 3)."""
        with profiler.span("model.field"):
            geo, feat = geo_net(pts)
            radiance = radiance_net(pts, rays_d, None, feat)
        return geo[..., 0], radiance

    def forward_pts_dir(self, pts, view_dir=None):
        """Direct query: (N, 3)[, (N, 3)] -> sigma (N,), rgb (N, 3); the view
        direction is normalised, zero when not given."""
        geo_net, radiance_net = self.get_net()
        rays_d = torch.zeros_like(pts) if view_dir is None else normalize(view_dir)
        return self._forward_pts_dir(geo_net, radiance_net, pts, rays_d)

    def get_net(self):
        """(geo_net, radiance_net) used for direct point queries."""
        raise NotImplementedError

    def forward_pts(self, pts):
        """Direct geometry query: (N, 3) -> sigma (N,)."""
        geo_net, _ = self.get_net()
        with profiler.span("model.field"):
            return geo_net(pts)[0][..., 0]

    def get_est_opacity(self, dt, pts):
        """opacity ~= sigma * dt (the instant-ngp convention)."""
        return self.forward_pts(pts) * dt
