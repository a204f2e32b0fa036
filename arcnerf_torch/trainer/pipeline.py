"""Training-ray pipeline: the ray pool on the device, random ray picks,
the background-colour composite and the dynamic batch size.

Counterpart of ``arcnerf_tpu/trainer/pipeline.py`` (``Pipeline``,
``_BS_BUCKETS``) together with the JAX trainer's on-device sampler
(``_sample_feed_impl``): all rays of all training images are concatenated
once into a pool that lives on the device, and each step draws its batch
there - uniform with replacement (``ray_sample.mode: random``) from a
seeded ``torch.Generator`` - with a random or fixed background colour
composited onto the ground truth where the images have masks. The
batch size follows the measured valid samples per ray on a power-of-two
ladder. Precrop and the host permutation walk (``mode: full``) are not
ported.
"""

import numpy as np
import torch

from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.device_consts import device_constant

# static bucket ladder for the dynamic batch size (powers of two)
_BS_BUCKETS = [1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072]
_POOL_KEYS = ("img", "mask", "rays_o", "rays_d", "rays_r", "bounds")


class Pipeline:

    def __init__(self, cfgs, n_rays, device):
        """cfgs: the dataset.train.scheduler node."""
        self.n_rays = int(n_rays)
        self.device = torch.device(device)
        ray_sample = get_value_from_cfgs_field(cfgs, "ray_sample", None)
        self.sample_mode = get_value_from_cfgs_field(ray_sample, "mode", "random")
        if self.sample_mode != "random":
            raise NotImplementedError("ray_sample.mode {} is not ported yet (ROADMAP Queue 1, item 4)".format(
                self.sample_mode))
        precrop = get_value_from_cfgs_field(cfgs, "precrop", None)
        ratio, max_epoch = (get_value_from_cfgs_field(precrop, k, d) for k, d in (("ratio", 1.0), ("max_epoch", 0)))
        if ratio < 1.0 and max_epoch:
            raise NotImplementedError("precrop is not ported yet (ROADMAP Queue 1, item 4)")
        bkg = get_value_from_cfgs_field(cfgs, "bkg_color", None)
        self.bkg_color_mode = get_value_from_cfgs_field(bkg, "color", None)
        dyn = get_value_from_cfgs_field(cfgs, "dynamic_batch_size", None)
        self.dynamic_update_epoch = get_value_from_cfgs_field(dyn, "update_epoch", None)
        self.dynamic_max_bs = get_value_from_cfgs_field(dyn, "max_batch_size", 32768)
        self.pool = None
        self.last_picks = None
        self._measured = []
        self.last_valid_per_ray = None

    def process_train_data(self, samples):
        """Concatenate the per-image dataset dicts into the device pool of
        (N_img * HW, ...) f32 tensors."""
        keys = [k for k in _POOL_KEYS if k in samples[0]]
        self.pool = {k: torch.from_numpy(np.concatenate([s[k] for s in samples], axis=0)).to(self.device)
                     for k in keys}
        return self.pool

    @property
    def n_total_rays(self):
        return self.pool["rays_o"].shape[0]

    def sample(self, generator):
        """One step's batch: dict of (1, n_rays, ...) tensors on the device.
        Its ray picks stay in ``last_picks``."""
        n = min(self.n_rays, self.n_total_rays)
        with profiler.span("train.draw"):
            select = torch.randint(0, self.n_total_rays, (n,), generator=generator, device=self.device)
            self.last_picks = select
            batch = self.composite_bkg_color({k: v[select][None] for k, v in self.pool.items()}, generator)
        return batch

    def composite_bkg_color(self, batch, generator=None):
        """Random or fixed background colour under the masks of the gt."""
        if self.bkg_color_mode is None or "mask" not in batch:
            return batch
        n = batch["rays_o"].shape[1]
        if self.bkg_color_mode == "random":
            color = torch.rand((1, n, 3), generator=generator, device=self.device)
        else:
            color = device_constant(self.bkg_color_mode, device=self.device).expand(1, n, 3)
        mask = batch["mask"][..., None]
        batch["img"] = batch["img"] * mask + color * (1.0 - mask)
        batch["bkg_color"] = color
        return batch

    def record_valid_pts(self, n_valid_pts, n_rays):
        """Keep a step's valid-sample count (a device tensor of its own, read
        only when the batch size is next updated: a strided step records
        its copy from the stats ring, never the static buffer a replay
        overwrites)."""
        self._measured.append((n_valid_pts, float(n_rays)))

    def update_dynamic_bs(self, epoch, log_max_allowance):
        """Every update_epoch steps, set n_rays so that the expected valid
        samples fill 2^log_max_allowance, on the bucket ladder. The one host
        read of the measured counts happens here."""
        if self.dynamic_update_epoch is None or log_max_allowance is None or log_max_allowance <= 0:
            return self.n_rays
        if epoch % self.dynamic_update_epoch != 0 or not self._measured:
            return self.n_rays
        with profiler.span("train.batch_size", epoch=epoch):
            counts = profiler.host_read(torch.stack([m[0] for m in self._measured]).float(), "train.batch_size",
                                        lambda t: t.cpu().tolist())
            valid_per_ray = sum(c / m[1] for c, m in zip(counts, self._measured)) / len(counts)
            self.last_valid_per_ray = valid_per_ray
            self._measured = []
            target = min(float(1 << log_max_allowance) / max(valid_per_ray, 1.0), float(self.dynamic_max_bs))
            for b in _BS_BUCKETS:
                if b >= target:
                    self.n_rays = b
                    break
            else:
                self.n_rays = min(_BS_BUCKETS[-1], int(self.dynamic_max_bs))
        return self.n_rays
