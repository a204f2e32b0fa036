"""Perspective camera: the part of ``arcnerf_tpu/render/camera.py``
(PerspectiveCamera) that ray generation needs. Intrinsic and pose live as
float64 numpy; rays are made in f32 torch on the CPU (dataset
preparation), as the JAX package makes them on its host backend.
"""

import numpy as np
import torch

from .ray_helper import get_rays


class PerspectiveCamera:

    def __init__(self, intrinsic, c2w, W=None, H=None):
        """intrinsic np(3, 3), c2w np(4, 4). W/H default to 2*cx, 2*cy."""
        self.intrinsic = np.asarray(intrinsic, dtype=np.float64).copy()
        self.c2w = np.asarray(c2w, dtype=np.float64).copy()
        self.W = int(W) if W is not None else int(round(self.intrinsic[0, 2] * 2))
        self.H = int(H) if H is not None else int(round(self.intrinsic[1, 2] * 2))

    def get_wh(self):
        return self.W, self.H

    def get_intrinsic(self):
        return self.intrinsic

    def get_pose(self):
        return self.c2w.copy()

    def get_rays(self, wh_order=True, index=None, center_pixel=False, normalize_rays_d=True):
        """Rays in world coords (CPU f32 tensors); see ray_helper.get_rays."""
        return get_rays(self.W, self.H, torch.as_tensor(self.intrinsic, dtype=torch.float32),
                        torch.as_tensor(self.c2w, dtype=torch.float32), wh_order, index, center_pixel=center_pixel,
                        normalize_rays_d=normalize_rays_d)
