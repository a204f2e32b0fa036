"""FullModel: the foreground model over (batch, rays, ...) inputs.

Counterpart of ``arcnerf_tpu/models/full_model.py`` without a background
model (rgb/sigma blending waits for the background models): inputs shaped
(B, N_rays, ...) are flattened, every other input (a per-chunk scalar such
as the window's ``cap_offset``) passes through as it is, and outputs are
shaped back.
"""

import torch
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

    def get_est_opacity(self, dt, pts):
        return self.fg_model.get_est_opacity(dt, pts)

    def forward(self, inputs, inference_only=True, get_progress=False, bound_state=None, generator=None):
        """inputs: rays_o/rays_d (B, N_rays, 3) (+ bkg_color (B, N_rays, 3)).
        Returns per-ray outputs shaped (B, N_rays, ...): rgb/depth/mask at
        inference, rgb_coarse/depth_coarse/mask_coarse in training, whose
        draws come from ``generator``."""
        batch_size, n_rays = inputs["rays_o"].shape[:2]
        flat = {}
        for k, v in inputs.items():
            if torch.is_tensor(v) and v.ndim >= 2 and v.shape[:2] == (batch_size, n_rays):
                flat[k] = v.reshape((batch_size * n_rays,) + v.shape[2:])
            elif v is not None:
                flat[k] = v
        bound_state = bound_state or {}
        output = self.fg_model(flat, inference_only, get_progress, bound_state=bound_state.get("fg", bound_state),
                               generator=generator)
        for k, v in output.items():
            if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == batch_size * n_rays:
                output[k] = v.reshape((batch_size, n_rays) + v.shape[1:])
        return output
