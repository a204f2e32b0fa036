"""FullModel: the foreground model over (batch, rays, ...) inputs.

Counterpart of ``arcnerf_tpu/models/full_model.py`` without a background
model (rgb/sigma blending is not ported yet).
"""

from torch import nn

from ..utils.cfgs import get_value_from_cfgs_field


class FullModel(nn.Module):

    def __init__(self, cfgs, fg_model):
        super().__init__()
        self.cfgs = cfgs
        self.fg_model = fg_model

    def get_chunk_rays(self):
        return get_value_from_cfgs_field(self.cfgs.model, "chunk_rays", 32768)

    def init_bound_state(self, device=None):
        return {"fg": self.fg_model.init_bound_state(device)}

    def forward(self, inputs, inference_only=True, get_progress=False, bound_state=None):
        """inputs: rays_o/rays_d (B, N_rays, 3) (+ bkg_color (B, N_rays, 3)).
        Returns per-ray outputs shaped (B, N_rays, ...)."""
        batch_size, n_rays = inputs["rays_o"].shape[:2]
        flat = {}
        for k, v in inputs.items():
            if v is not None and v.ndim >= 2 and v.shape[:2] == (batch_size, n_rays):
                flat[k] = v.reshape((batch_size * n_rays,) + v.shape[2:])
        bound_state = bound_state or {}
        output = self.fg_model(flat, inference_only, get_progress, bound_state=bound_state.get("fg", bound_state))
        for k, v in output.items():
            if v.ndim >= 1 and v.shape[0] == batch_size * n_rays:
                output[k] = v.reshape((batch_size, n_rays) + v.shape[1:])
        return output
