"""NeRF density model; with a HashGridEmbedder + fused MLP nets and a volume
bound it is the NGP recipe (``configs/models/nerf_ngp.yaml``).

Counterpart of ``arcnerf_tpu/models/nerf_model.py``: ``setup`` and
``_forward``'s dispatch, at inference and in training: the compacted-stream
render where it applies (on the fused sampler's stream, the windows of the
transmittance-continuation render included, or the grid's mask), else the
dense path (sigma and radiance on the (rays, samples) grid, then
``ray_marching``), which also serves the progress outputs and the windows
off the fix-step ladder.
Importance resampling raises NotImplementedError.
"""

import torch

from ..utils import profiler
from ..utils.registry import MODEL_REGISTRY
from .base_modules import build_geo_model, build_radiance_model
from .fg_model import FgModel


@MODEL_REGISTRY.register()
class NeRF(FgModel):

    def __init__(self, cfgs, generator=None):
        super().__init__(cfgs)
        if self.get_ray_cfgs("n_importance") > 0:
            raise NotImplementedError("importance resampling (n_importance > 0) is not ported yet "
                                      "(ROADMAP Queue 1, item 4)")
        self.coarse_geo_net = build_geo_model(cfgs.model.geometry, generator)
        self.coarse_radiance_net = build_radiance_model(cfgs.model.radiance, generator)

    def get_net(self):
        return self.coarse_geo_net, self.coarse_radiance_net

    def _forward(self, inputs, inference_only=True, get_progress=False, generator=None):
        """The compacted-stream render (kernels C and F on the card): on the
        fused sampler's stream when ``forward`` made one, else on the grid's
        mask when it is in ladder order and neither progress outputs nor a
        window are asked for; else the dense path. Training keys carry the
        ``_coarse`` suffix, as the JAX ``adjust_coarse_fine_output`` gives
        them."""
        if not self.use_scattered_masks():
            raise NotImplementedError("left-compacted marching is not ported yet (ROADMAP Queue 1, item 4)")
        bkg_color = inputs.get("bkg_color")
        geo_net, radiance_net = self.get_net()
        if "stream" in inputs:
            out = self.render_stream(geo_net, radiance_net, inputs["stream"], inference_only, bkg_color, generator)
            return self.adjust_coarse_fine_output({"coarse": out}, inference_only)
        rays_o, rays_d, zvals, mask_pts = inputs["rays_o"], inputs["rays_d"], inputs["zvals"], inputs["mask_pts"]
        if not get_progress and mask_pts is not None and "mask_march" not in inputs:
            out = self.fused_render_by_mask_pts(geo_net, radiance_net, rays_o, rays_d, zvals, mask_pts,
                                                inference_only, bkg_color=bkg_color, generator=generator)
            if out is not None:
                return self.adjust_coarse_fine_output({"coarse": out}, inference_only)

        sigma, radiance = self.get_sigma_radiance_by_mask_pts(geo_net, radiance_net, rays_o, rays_d, zvals, mask_pts,
                                                              inference_only)
        march_mask = inputs.get("mask_march", mask_pts)
        if "mask_march" in inputs:
            # only the window's samples shade; the others march with sigma 0.
            # Compaction leaves them at 0, but a chunk whose budget covers
            # every sample skips it (the JAX package shades them there)
            sigma = torch.where(mask_pts, sigma, 0.0)
        with profiler.span("model.march"):
            out = self.ray_marching_wrap(sigma, radiance, zvals, inference_only=inference_only, bkg_color=bkg_color,
                                         mask_pts=march_mask, generator=generator)
        return self.adjust_coarse_fine_output({"coarse": self.output_get_progress(out, get_progress)},
                                              inference_only)
