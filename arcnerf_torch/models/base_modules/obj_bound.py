"""Object bounds that constrain ray sampling.

Counterpart of ``arcnerf_tpu/models/base_modules/obj_bound.py``: the
per-ray inference sample cap, the occupancy mask, ``build_obj_bound``,
``BasicBound`` and ``VolumeBound``'s state, near/far and occupancy-culled
sampling in ladder order (``keep_order=True``). Bounds hold static geometry
only; the occupancy state is an explicit dict of tensors.
``VolumeBound.optimize`` (the occupancy update) lands with training.
"""

import torch

from ...geometry.volume import Volume
from ...render.ray_helper import get_near_far_from_rays, get_zvals_from_near_far, get_zvals_from_near_far_fix_step
from ...utils.cfgs import get_value_from_cfgs_field, valid_key_in_cfgs
from ...utils.registry import BOUND_REGISTRY


def _cap_pts_per_ray(mask_pts, inference_only, cap):
    """At inference keep only the first ``cap`` valid samples per ray,
    front to back (the early-termination analogue; it also bounds a chunk's
    compacted point count at n_rays * cap)."""
    if not inference_only or not cap:
        return mask_pts
    rank = torch.cumsum(mask_pts.to(torch.int32), dim=1)
    return mask_pts & (rank <= int(cap))


def _occ_mask_soa(volume, bitfield, rays_o, rays_d, zvals):
    """(B,) rays x (B, N) zvals -> (B, N) in-occupied-voxel mask, computed
    axis by axis (no (B, N, 3) point tensor)."""
    x = rays_o[:, 0:1] + zvals * rays_d[:, 0:1]
    y = rays_o[:, 1:2] + zvals * rays_d[:, 1:2]
    z = rays_o[:, 2:3] + zvals * rays_d[:, 2:3]
    flat, valid = volume.get_flat_voxel_idx_from_coords(x, y, z)
    return volume.check_flat_in_occ_voxel(flat, valid, bitfield)


def build_obj_bound(cfgs):
    """Pick the bound from cfgs.obj_bound keys: volume > sphere > bitfield >
    basic. Returns (bound, type). Only the basic and volume bounds are ported."""
    if not valid_key_in_cfgs(cfgs, "obj_bound"):
        return BasicBound(None), "basic"
    keys = cfgs.obj_bound.keys()
    if "volume" in keys:
        return VolumeBound(cfgs.obj_bound), "volume"
    if "sphere" in keys or "bitfield" in keys:
        raise NotImplementedError("SphereBound/BitfieldBound are not ported yet (ROADMAP Queue 1, item 9)")
    return BasicBound(cfgs.obj_bound), "basic"


@BOUND_REGISTRY.register()
class BasicBound:
    """No structure: near/far from hardcode/bounds/bounding sphere."""

    def __init__(self, cfgs):
        self.cfgs = cfgs
        self.optim_cfgs = self.read_optim_cfgs()

    def read_optim_cfgs(self):
        return {
            "epoch_optim": get_value_from_cfgs_field(self.cfgs, "epoch_optim", None),
            "epoch_optim_warmup": get_value_from_cfgs_field(self.cfgs, "epoch_optim_warmup", None),
            "ema_optim_decay": get_value_from_cfgs_field(self.cfgs, "ema_optim_decay", 0.95),
            "opa_thres": get_value_from_cfgs_field(self.cfgs, "opa_thres", 0.01),
            "eval_n_sample": get_value_from_cfgs_field(self.cfgs, "eval_n_sample", None),
        }

    def get_optim_cfgs(self, key=None):
        return self.optim_cfgs if key is None else self.optim_cfgs[key]

    def init_state(self, device=None):
        """Occupancy state (empty for unstructured bounds)."""
        return {}

    def get_near_far_from_rays(self, state, inputs, near_hardcode=None, far_hardcode=None, bounding_radius=None):
        """-> near (B, 1), far (B, 1), mask_rays (B,)|None."""
        near, far = get_near_far_from_rays(inputs["rays_o"], inputs["rays_d"], inputs.get("bounds"), near_hardcode,
                                           far_hardcode, bounding_radius)
        return near, far, None

    def get_zvals_from_near_far(self, state, near, far, n_pts, inference_only=False, inverse_linear=False,
                                rays_o=None, rays_d=None, keep_order=False):
        """-> zvals (B, n_pts), mask_pts (B, n_pts)|None."""
        return get_zvals_from_near_far(near, far, n_pts, inverse_linear=inverse_linear), None


@BOUND_REGISTRY.register()
class VolumeBound(BasicBound):
    """Dense voxel volume with an occupancy bitfield.

    State: {'bitfield': (n, n, n) bool, 'opafield': (n, n, n) f32}.
    Sampling: ray/volume AABB near-far; with ray_sample_acc, const-step (or
    stratified) zvals masked by occupancy, in ladder order.
    """

    def __init__(self, cfgs):
        super().__init__(cfgs)
        assert valid_key_in_cfgs(cfgs, "volume"), "VolumeBound needs cfgs.volume"
        vol_cfgs = {k: v for k, v in cfgs.volume.items()}
        vol_cfgs.setdefault("n_grid", 128)
        if isinstance(vol_cfgs.get("origin"), list):
            vol_cfgs["origin"] = tuple(vol_cfgs["origin"])
        self.volume = Volume(**vol_cfgs)

    def get_obj_bound(self):
        return self.volume

    def read_optim_cfgs(self):
        params = super().read_optim_cfgs()
        params["ray_sample_acc"] = get_value_from_cfgs_field(self.cfgs, "ray_sample_acc", False)
        params["ray_sample_fix_step"] = get_value_from_cfgs_field(self.cfgs, "ray_sample_fix_step", False)
        params["near_distance"] = get_value_from_cfgs_field(self.cfgs, "near_distance", 0.0)
        params["eval_max_pts_per_ray"] = get_value_from_cfgs_field(self.cfgs, "eval_max_pts_per_ray", None)
        if get_value_from_cfgs_field(self.cfgs, "eval_cap_window", False):
            raise NotImplementedError("windowed rendering (eval_cap_window) is not ported yet "
                                      "(ROADMAP Queue 1, item 8)")
        return params

    def init_state(self, device=None):
        if self.get_optim_cfgs("epoch_optim") is None:
            return {}
        return {
            "bitfield": self.volume.create_bitfield(init_occ=True, device=device),
            "opafield": self.volume.create_opafield(device=device),
        }

    def get_near_far_from_rays(self, state, inputs, **kwargs):
        near, far, _, mask = self.volume.ray_volume_intersection(inputs["rays_o"], inputs["rays_d"])
        return near, far, mask[:, 0]

    def get_zvals_from_near_far(self, state, near, far, n_pts, inference_only=False, inverse_linear=False,
                                rays_o=None, rays_d=None, keep_order=False):
        use_acc = self.get_optim_cfgs("epoch_optim") is not None and self.get_optim_cfgs("ray_sample_acc")
        if not use_acc or "bitfield" not in state:
            return super().get_zvals_from_near_far(state, near, far, n_pts, inference_only, inverse_linear)
        if not keep_order:
            raise NotImplementedError("left-compacted sampling (handle_valid_mask_zvals) is not ported yet "
                                      "(ROADMAP Queue 1, item 9)")
        if self.get_optim_cfgs("ray_sample_fix_step"):
            fix_t = self.volume.get_diag_len() / n_pts
            zvals, mask_pts = get_zvals_from_near_far_fix_step(near, far, fix_t, n_pts)
        else:
            zvals = get_zvals_from_near_far(near, far, n_pts, inverse_linear=inverse_linear)
            mask_pts = torch.ones_like(zvals, dtype=torch.bool)
        mask_pts = mask_pts & _occ_mask_soa(self.volume, state["bitfield"], rays_o, rays_d, zvals)
        return zvals, _cap_pts_per_ray(mask_pts, inference_only, self.get_optim_cfgs("eval_max_pts_per_ray"))
