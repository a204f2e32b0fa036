"""NeRF density model; with a HashGridEmbedder + fused MLP nets and a volume
bound it is the NGP recipe (``configs/models/nerf_ngp.yaml``).

Counterpart of ``arcnerf_tpu/models/nerf_model.py``: ``setup`` and the
compacted-stream branch of ``_forward``. Configurations that leave that
branch (importance resampling, the dense path) raise NotImplementedError.
"""

from ..utils.registry import MODEL_REGISTRY
from .base_modules import build_geo_model, build_radiance_model
from .fg_model import FgModel


@MODEL_REGISTRY.register()
class NeRF(FgModel):

    def __init__(self, cfgs, generator=None):
        super().__init__(cfgs)
        if self.get_ray_cfgs("n_importance") > 0:
            raise NotImplementedError("importance resampling (n_importance > 0) is not ported yet "
                                      "(ROADMAP Queue 1, item 9)")
        self.coarse_geo_net = build_geo_model(cfgs.model.geometry, generator)
        self.coarse_radiance_net = build_radiance_model(cfgs.model.radiance, generator)

    def get_net(self):
        return self.coarse_geo_net, self.coarse_radiance_net

    def _forward(self, inputs):
        if not self.use_scattered_masks():
            raise NotImplementedError("left-compacted marching is not ported yet (ROADMAP Queue 1, item 9)")
        return self.fused_render_by_mask_pts(
            self.coarse_geo_net, self.coarse_radiance_net, inputs["rays_o"], inputs["rays_d"], inputs["zvals"],
            inputs["mask_pts"], bkg_color=inputs.get("bkg_color"))
