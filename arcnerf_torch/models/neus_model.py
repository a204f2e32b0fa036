"""NeuS: SDF to alpha with a learned scale (Wang et al., arXiv 2106.10689,
eq. 13), on the fused sampler's stream of sections.

Counterpart of ``arcnerf_tpu/models/neus_model.py`` (``sdf_to_alpha``,
``Neus._forward``, ``handle_mid_pts``, ``get_est_opacity``). The sampler
writes each ray's sections (mid points and lengths, ``sample_compact``'s
sections mode); the geometry chain gives each section's sdf, feature and
normal (``geo_with_grad``); the radiance net takes [pts, view, normal,
feature]; alpha comes from the section's sdf and slope with scale
exp(speed_factor * inv_s) and the annealed slope; ``segment_march``
composites the alphas (kernels C and F in their alpha mode).

Departures from the JAX package, each a consequence of marching the stream
rather than the (rays, n_sample) grid (ROADMAP Queue 3): a ray has
min(c + 1, n_sample) sections for c samples and none without a sample
(the JAX grid keeps one there); the padding sections past them (length 0,
each an alpha of ~1e-5 / cdf) are not marched; the point budget cuts a
ray's sections off where the JAX path evaluates the sections past it at
sdf 0; the eikonal loss averages the kept sections' normals once each
(the JAX mean repeats the last section's normal over the padding); and
n_valid_pts counts sections. Importance upsampling (n_importance > 0) is
not ported.
"""

import math

import torch

from ..geometry.transformation import normalize
from ..render.ray_helper import march_group, segment_march
from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.registry import MODEL_REGISTRY
from .base_modules import build_geo_model, build_radiance_model
from .sdf_model import SdfModel, geo_with_grad


def sdf_to_alpha(mid_sdf, dist, mid_slope, s, clip=True):
    """NeuS eq. 13 over sections of length ``dist`` whose mid point has
    ``mid_sdf`` and ``mid_slope``: alpha = (cdf(prev) - cdf(next) + 1e-5) /
    (cdf(prev) + 1e-5), cdf = sigmoid(s sdf), prev/next the sdf extended
    half a length back and forth along the slope; clipped to [0, 1]."""
    prev_sdf = mid_sdf - mid_slope * dist * 0.5
    next_sdf = mid_sdf + mid_slope * dist * 0.5
    prev_cdf = torch.sigmoid(prev_sdf * s)
    next_cdf = torch.sigmoid(next_sdf * s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return alpha.clamp(0.0, 1.0) if clip else alpha


@MODEL_REGISTRY.register()
class Neus(SdfModel):

    def __init__(self, cfgs, generator=None):
        super().__init__(cfgs)
        if self.get_ray_cfgs("n_importance") > 0:
            raise NotImplementedError("NeuS's sdf-guided upsampling (n_importance > 0) is not ported yet "
                                      "(ROADMAP Queue 1, item 4)")
        params = get_value_from_cfgs_field(cfgs.model, "params", None)
        self.speed_factor = float(get_value_from_cfgs_field(params, "speed_factor", 10))
        self.anneal_end = float(get_value_from_cfgs_field(params, "anneal_end", 0))
        init_var = float(get_value_from_cfgs_field(params, "init_var", 0.05))
        self.geo_net = build_geo_model(cfgs.model.geometry, generator)
        self.radiance_net = build_radiance_model(cfgs.model.radiance, generator)
        self.inv_s = torch.nn.Parameter(torch.tensor([-math.log(init_var) / self.speed_factor]))

    def get_net(self):
        return self.geo_net, self.radiance_net

    def forward_scale(self):
        return torch.exp(self.inv_s * self.speed_factor)

    def get_cos_anneal(self, cur_epoch):
        """min(1, epoch / anneal_end): a device tensor for a device epoch
        (the trainer's count of updates), so a captured step reads it."""
        if self.anneal_end == 0 or cur_epoch is None:
            return 1.0
        return torch.clamp_max(cur_epoch / self.anneal_end, 1.0)

    def section_alpha(self, sdf, dist, dirs, normal, cos_anneal):
        """Each section's alpha from its mid point's sdf (B,), length (B,),
        the ray's direction and the normal there (B, 3)."""
        slope = (dirs * normal).sum(-1)
        iter_slope = -(torch.relu(-slope * 0.5 + 0.5) * (1 - cos_anneal) + torch.relu(-slope) * cos_anneal)
        return sdf_to_alpha(sdf, dist, iter_slope, self.forward_scale())

    def _forward(self, inputs, inference_only=True, get_progress=False, generator=None):
        if "stream" not in inputs:
            raise NotImplementedError("an SDF model off the fused sampler's stream (left-compacted sampling) is "
                                      "not ported yet (ROADMAP Queue 1, item 4)")
        stream = inputs["stream"]
        pts, dirs = stream["pts"], stream["dirs"]
        sdf, feat, normal = geo_with_grad(self.geo_net, pts, create_graph=not inference_only)
        with profiler.span("model.field"):
            radiance = self.radiance_net(pts, dirs, normal, feat)
        with profiler.span("model.sdf_alpha"):
            cos_anneal = 1.0 if inference_only else self.get_cos_anneal(inputs.get("cur_epoch"))
            alpha = self.section_alpha(sdf[:, 0], stream["len"], dirs, normal, cos_anneal)
        group = march_group(self.get_render_cfgs("eval_max_pts_per_ray") if inference_only else None)
        bkg_color, white_bkg = inputs.get("bkg_color"), self.get_ray_cfgs("white_bkg")
        with profiler.span("model.march"):
            out = segment_march(alpha, radiance, stream["z"], stream["off"], stream["cnt"], white_bkg=white_bkg,
                                bkg_color=bkg_color, group=group, alpha=True)
            out.pop("trans_end")
            if inference_only:
                # the weights' sum of the unit normals: the same march with the normals as colours
                unit = segment_march(alpha, normalize(normal), stream["z"], stream["off"], stream["cnt"],
                                     group=group, alpha=True)
                out["normal"] = unit["rgb"]
        if not inference_only:
            n_kept = stream["cnt"].sum()
            out["normal_pts"] = normal
            out["normal_pts_valid"] = torch.arange(normal.shape[0], device=normal.device) < n_kept
            out["params"] = {"scale": self.forward_scale()[0]}
        return out

    def count_stream(self, n_valid, n_rays):
        """The fused sampler's counters, and the sections whose normals
        the call takes: every kept one, the valid sections up to the
        stream's budget."""
        super().count_stream(n_valid, n_rays)
        profiler.count("sdf.normal_pts", n_valid.clamp_max(self.stream_budget(n_rays, True)).sum())

    def get_est_opacity(self, dt, pts):
        """The occupancy update's opacity: alpha over a section of length
        dt / sqrt(3) along -pts, from the sdf and the first-order normal."""
        rays_d = -normalize(pts)
        sdf, _, normal = geo_with_grad(self.geo_net, pts)
        if profiler.active():
            profiler.count("sdf.normal_pts", pts.shape[0])
        with profiler.span("model.sdf_alpha"):
            slope = (rays_d * normal).sum(-1)
            dist = torch.full_like(slope, dt / math.sqrt(3.0))
            return sdf_to_alpha(sdf[:, 0], dist, -torch.relu(-slope), self.forward_scale())
