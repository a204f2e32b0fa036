"""Base 3d dataset: images + cameras + ray precaching, numpy batches.

Counterpart of the parts of ``arcnerf_tpu/datasets/base.py`` that an
analytic scene needs: skip decimation, the eval subset nearest the average
pose, ``get_intrinsic``, ray precaching and ``__getitem__``. Pose
normalisation, rescaling and the capture-data helpers wait for the datasets
that use them.
"""

import numpy as np

from ..utils.cfgs import get_value_from_cfgs_field


class Base3dDataset:

    def __init__(self, cfgs, data_dir, mode="train", transforms=None):
        self.cfgs = cfgs
        self.data_dir = data_dir
        self.mode = mode
        self.transforms = transforms

        self.images = []
        self.masks = []
        self.cameras = []
        self.bounds = []
        self.n_imgs = 0
        self.H, self.W = 0, 0
        self.identifier = ""
        self.ray_bundles = None
        self.precache = False

        self.skip = get_value_from_cfgs_field(cfgs, "skip", 1)
        self.eval_max_sample = get_value_from_cfgs_field(cfgs, "eval_max_sample")
        if get_value_from_cfgs_field(cfgs, "ndc_space", False):
            raise NotImplementedError("NDC rays (LLFF) are not ported yet (ROADMAP Queue 1, item 4)")
        self.center_pixel = get_value_from_cfgs_field(cfgs, "center_pixel", False)
        self.normalize_rays_d = get_value_from_cfgs_field(cfgs, "normalize_rays_d", True)

    def apply_holdout(self, holdout_index):
        self.images = [self.images[i] for i in holdout_index]
        self.masks = [self.masks[i] for i in holdout_index] if self.masks else []
        self.cameras = [self.cameras[i] for i in holdout_index]
        self.bounds = [self.bounds[i] for i in holdout_index] if self.bounds else []
        self.n_imgs = len(holdout_index)

    def skip_samples(self):
        if self.skip > 1:
            self.apply_holdout(list(range(self.n_imgs))[:: self.skip])

    def keep_eval_samples(self):
        """Eval keeps at most eval_max_sample images nearest the avg pose."""
        if self.eval_max_sample is None or self.eval_max_sample >= self.n_imgs:
            return
        self.apply_holdout(self.find_closest_cam_ind(self.eval_max_sample))

    def get_intrinsic(self, idx=0):
        """Camera ``idx``'s (3, 3) intrinsic, float64 numpy."""
        return self.cameras[idx].get_intrinsic()

    def find_closest_cam_ind(self, n_close):
        c2ws = np.stack([cam.get_pose() for cam in self.cameras])
        center = c2ws[:, :3, 3].mean(0)
        dist = np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1)
        return np.argsort(dist)[:n_close].tolist()

    def _camera_rays(self, cam):
        ro, rd, _, rr = cam.get_rays(wh_order=False, center_pixel=self.center_pixel,
                                     normalize_rays_d=self.normalize_rays_d)
        return ro.numpy(), rd.numpy(), rr.numpy()

    def precache_ray(self):
        if self.ray_bundles is None:
            self.ray_bundles = [self._camera_rays(cam) for cam in self.cameras]
            self.precache = True

    def __len__(self):
        return self.n_imgs

    def __getitem__(self, idx):
        img = self.images[idx].reshape(-1, 3).astype(np.float32)
        mask = self.masks[idx].reshape(-1).astype(np.float32) if self.masks else None
        if self.precache:
            rays_o, rays_d, rays_r = self.ray_bundles[idx]
        else:
            rays_o, rays_d, rays_r = self._camera_rays(self.cameras[idx])

        bounds = None
        if self.bounds:
            bounds = np.tile(np.asarray(self.bounds[idx], dtype=np.float32)[None], (img.shape[0], 1))

        inputs = {
            "img": img,
            "mask": mask,
            "c2w": self.cameras[idx].get_pose().astype(np.float32),
            "intrinsic": self.cameras[idx].get_intrinsic().astype(np.float32),
            "rays_o": rays_o.astype(np.float32),
            "rays_d": rays_d.astype(np.float32),
            "rays_r": rays_r.astype(np.float32),
            "H": self.H,
            "W": self.W,
            "bounds": bounds,
        }
        inputs = {k: v for k, v in inputs.items() if v is not None}
        if self.transforms is not None:
            inputs = self.transforms(inputs)
        return inputs
