"""Object bounds that constrain ray sampling.

Counterpart of ``arcnerf_tpu/models/base_modules/obj_bound.py``: the
per-ray inference sample cap and its windows, the occupancy mask,
``build_obj_bound``, ``BasicBound``, ``SphereBound``'s near/far, and
``VolumeBound``'s state, near/far,
occupancy-culled sampling in ladder order (``keep_order=True``) with the
training jitter, the window mode of the transmittance-continuation render,
and ``VolumeBound.optimize``, the occupancy update. Bounds hold static
geometry only; the occupancy state is an explicit dict of tensors, and the
draws come from a ``torch.Generator`` (or are fed explicitly by tests).

The fix-step occupancy ladder has one owner, ``occupied_ladder`` (its step
``ladder_step``): the sampler here, ``sample_compact`` and the render
engine's prepasses (through ``VolumeBound.ladder``) all ask it.

A bound reads its optim cfgs once, at construction; the JAX package instead
rebuilds its bound whenever the cfgs change. So whoever edits the obj_bound
cfgs after construction (``RenderEngine.set_render_cap``) calls
``refresh_optim_cfgs``, else the bound keeps serving the old values.
"""

import torch

from ...geometry.ray import sphere_ray_intersection
from ...geometry.volume import Volume, convert_flatten_index_to_xyz_index
from ...render.ray_helper import get_near_far_from_rays, get_zvals_from_near_far, get_zvals_from_near_far_fix_step
from ...utils.cfgs import get_value_from_cfgs_field, valid_key_in_cfgs
from ...utils.registry import BOUND_REGISTRY


def _cap_pts_per_ray(mask_pts, inference_only, cap, offset=None):
    """At inference keep only the first ``cap`` valid samples per ray,
    front to back (the early-termination analogue; it also bounds a chunk's
    compacted point count at n_rays * cap). ``offset`` (an int or None)
    keeps a later window instead: the valid samples of rank in
    (offset, offset + cap]."""
    if not inference_only or not cap:
        return mask_pts
    rank = torch.cumsum(mask_pts.to(torch.int32), dim=1)
    if offset is None:
        return mask_pts & (rank <= int(cap))
    return mask_pts & (rank > offset) & (rank <= offset + int(cap))


def _occ_mask_soa(volume, bitfield, rays_o, rays_d, zvals):
    """(B,) rays x (B, N) zvals -> (B, N) in-occupied-voxel mask, computed
    axis by axis (no (B, N, 3) point tensor)."""
    x = rays_o[:, 0:1] + zvals * rays_d[:, 0:1]
    y = rays_o[:, 1:2] + zvals * rays_d[:, 1:2]
    z = rays_o[:, 2:3] + zvals * rays_d[:, 2:3]
    flat, valid = volume.get_flat_voxel_idx_from_coords(x, y, z)
    return volume.check_flat_in_occ_voxel(flat, valid, bitfield)


def ladder_step(volume, n_pts):
    """The fix-step ladder's step: the volume's diagonal over its slots."""
    return volume.get_diag_len() / n_pts


def occupied_ladder(volume, bitfield, rays_o, rays_d, near, far, n_pts, generator=None, rand=None):
    """The fix-step ladder of ``n_pts`` slots on near, far (B, 1), jittered
    by ``generator`` or ``rand`` (B, n_pts) -> zvals (B, n_pts) and the mask
    of its slots off the clamped tail and in occupied voxels, before any cap."""
    zvals, mask = get_zvals_from_near_far_fix_step(near, far, ladder_step(volume, n_pts), n_pts,
                                                   generator=generator, rand=rand)
    return zvals, mask & _occ_mask_soa(volume, bitfield, rays_o, rays_d, zvals)


def build_obj_bound(cfgs):
    """Pick the bound from cfgs.obj_bound keys: volume > sphere > bitfield >
    basic. Returns (bound, type). The basic, sphere and volume bounds are
    ported; BitfieldBound is not."""
    if not valid_key_in_cfgs(cfgs, "obj_bound"):
        return BasicBound(None), "basic"
    keys = cfgs.obj_bound.keys()
    if "volume" in keys:
        return VolumeBound(cfgs.obj_bound), "volume"
    if "sphere" in keys:
        return SphereBound(cfgs.obj_bound), "sphere"
    if "bitfield" in keys:
        raise NotImplementedError("BitfieldBound is not ported yet (ROADMAP Queue 1, item 4)")
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

    def refresh_optim_cfgs(self):
        """Re-read the optim cfgs after an edit of the obj_bound cfgs."""
        self.optim_cfgs = self.read_optim_cfgs()

    def init_state(self, device=None):
        """Occupancy state (empty for unstructured bounds)."""
        return {}

    def occupancy_ladder(self, state):
        """Whether the bound samples the fix-step ladder culled by its
        occupancy bitfield in ``state`` (no: no structure)."""
        return False

    def window(self, cap_offset, inference_only):
        """The start of a call's window (an int) where the window mode
        engages, else None (no structure: never)."""
        return None

    def get_near_far_from_rays(self, state, inputs, near_hardcode=None, far_hardcode=None, bounding_radius=None):
        """-> near (B, 1), far (B, 1), mask_rays (B,)|None."""
        near, far = get_near_far_from_rays(inputs["rays_o"], inputs["rays_d"], inputs.get("bounds"), near_hardcode,
                                           far_hardcode, bounding_radius)
        return near, far, None

    def get_zvals_from_near_far(self, state, near, far, n_pts, inference_only=False, inverse_linear=False,
                                perturb=False, generator=None, rays_o=None, rays_d=None, keep_order=False,
                                cap_offset=None):
        """-> zvals (B, n_pts), mask_pts (B, n_pts)|None. With ``perturb``
        outside inference the zvals are jittered from ``generator``."""
        jitter = generator if perturb and not inference_only else None
        return get_zvals_from_near_far(near, far, n_pts, inverse_linear=inverse_linear, generator=jitter), None


@BOUND_REGISTRY.register()
class SphereBound(BasicBound):
    """A sphere (``sphere.radius``, ``sphere.origin``): near and far where a
    ray crosses it, rays that miss it marked invalid; no occupancy state."""

    def __init__(self, cfgs):
        super().__init__(cfgs)
        sphere = cfgs.sphere
        self.origin = tuple(float(v) for v in get_value_from_cfgs_field(sphere, "origin", (0.0, 0.0, 0.0)))
        self.radius = float(get_value_from_cfgs_field(sphere, "radius", 1.0))

    def get_near_far_from_rays(self, state, inputs, **kwargs):
        near, far, _, mask = sphere_ray_intersection(inputs["rays_o"], inputs["rays_d"], self.radius, self.origin)
        return near, far, mask[:, 0]


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
        # transmittance-continuation windows (RenderEngine.render_image_windowed):
        # the cap becomes a rank window, and sampling also returns the
        # pre-cap occupancy mask to march with
        params["eval_cap_window"] = get_value_from_cfgs_field(self.cfgs, "eval_cap_window", False)
        return params

    def init_state(self, device=None):
        if self.get_optim_cfgs("epoch_optim") is None:
            return {}
        return {
            "bitfield": self.volume.create_bitfield(init_occ=True, device=device),
            "opafield": self.volume.create_opafield(device=device),
        }

    def occupancy_ladder(self, state):
        """Whether the sampler walks the fix-step ladder and culls it by the
        bitfield of ``state``: ray_sample_acc and ray_sample_fix_step set,
        occupancy updates on (epoch_optim) and a bitfield present."""
        return ("bitfield" in state and self.get_optim_cfgs("epoch_optim") is not None
                and bool(self.get_optim_cfgs("ray_sample_acc")) and bool(self.get_optim_cfgs("ray_sample_fix_step")))

    def window(self, cap_offset, inference_only):
        """The start of a call's window (an int): ``cap_offset`` where the
        window mode engages (eval_cap_window set, at inference and with a
        ``cap_offset`` fed), else None: the call samples as a plain one."""
        if cap_offset is None or not inference_only or not self.get_optim_cfgs("eval_cap_window"):
            return None
        return int(cap_offset)

    def get_near_far_from_rays(self, state, inputs, **kwargs):
        near, far, _, mask = self.volume.ray_volume_intersection(inputs["rays_o"], inputs["rays_d"])
        return near, far, mask[:, 0]

    def ladder(self, state, rays_o, rays_d, near, far, n_pts, generator=None):
        """``occupied_ladder`` on this volume and the bitfield of ``state``."""
        return occupied_ladder(self.volume, state["bitfield"], rays_o, rays_d, near, far, n_pts, generator)

    def occupied(self, state, rays_o, rays_d, zvals):
        """(B, N): whether each of ``zvals`` (B, N) lies in an occupied voxel."""
        return _occ_mask_soa(self.volume, state["bitfield"], rays_o, rays_d, zvals)

    def get_zvals_from_near_far(self, state, near, far, n_pts, inference_only=False, inverse_linear=False,
                                perturb=False, generator=None, rays_o=None, rays_d=None, keep_order=False,
                                cap_offset=None):
        """As ``BasicBound``'s, with the samples masked by occupancy and, at
        inference, capped. In the window mode (``window``) the mask is the
        pair (window mask, pre-cap mask)."""
        use_acc = self.get_optim_cfgs("epoch_optim") is not None and self.get_optim_cfgs("ray_sample_acc")
        if not use_acc or "bitfield" not in state:
            return super().get_zvals_from_near_far(state, near, far, n_pts, inference_only, inverse_linear, perturb,
                                                   generator)
        if not keep_order:
            raise NotImplementedError("left-compacted sampling (handle_valid_mask_zvals) is not ported yet "
                                      "(ROADMAP Queue 1, item 4)")
        jitter = generator if perturb and not inference_only else None
        if self.get_optim_cfgs("ray_sample_fix_step"):
            zvals, mask_pts = self.ladder(state, rays_o, rays_d, near, far, n_pts, jitter)
        else:
            zvals = get_zvals_from_near_far(near, far, n_pts, inverse_linear=inverse_linear, generator=jitter)
            mask_pts = self.occupied(state, rays_o, rays_d, zvals)
        window = self.window(cap_offset, inference_only)
        mask_cap = _cap_pts_per_ray(mask_pts, inference_only, self.get_optim_cfgs("eval_max_pts_per_ray"),
                                    offset=window)
        if window is not None:
            return zvals, (mask_cap, mask_pts)
        return zvals, mask_cap

    def optimize(self, state, cur_epoch=0, n_pts=128, get_est_opacity=None, generator=None, flat_idx=None,
                 noise_u=None):
        """Opacity-EMA voxel pruning (JAX ``VolumeBound.optimize``).

        Warmup (cur_epoch < epoch_optim_warmup): evaluate every voxel
        centre. After: n_voxel/4 voxels drawn uniformly without replacement
        (``randperm``) plus n_voxel/4 drawn with replacement from the
        occupied ones (``multinomial``; uniform when none is occupied,
        where the JAX draw is undefined). Each point is jittered within
        its voxel by ``noise_u`` - 0.5 voxel. ``flat_idx`` and ``noise_u``
        (uniform, (N, 3)) may be fed to reproduce given draws; else they
        come from ``generator``. Returns the new {bitfield, opafield}."""
        if not state or get_est_opacity is None:
            return state
        warmup_until = self.get_optim_cfgs("epoch_optim_warmup")
        vol = self.volume
        n_voxel = vol.get_n_voxel()
        bitfield, opafield = state["bitfield"], state["opafield"]
        dev = bitfield.device
        if flat_idx is None:
            if warmup_until is not None and cur_epoch < warmup_until:
                flat_idx = torch.arange(n_voxel, device=dev)
            else:
                n_sample = n_voxel // 4
                uni = torch.randperm(n_voxel, generator=generator, device=dev)[:n_sample]
                occ_p = bitfield.reshape(-1).to(torch.float32)
                occ_p = torch.where(occ_p.sum() > 0, occ_p, torch.ones_like(occ_p))
                occ = torch.multinomial(occ_p, n_sample, replacement=True, generator=generator)
                flat_idx = torch.cat([uni, occ])
        flat_idx = flat_idx.to(device=dev, dtype=torch.int64)
        pts = vol.get_voxel_pts_by_voxel_idx(convert_flatten_index_to_xyz_index(flat_idx, vol.get_n_grid()))
        if noise_u is None:
            noise_u = torch.rand(pts.shape, generator=generator, device=dev)
        pts = pts + (noise_u - 0.5) * vol.get_voxel_size(to_list=False, device=dev)

        opacity = get_est_opacity(vol.get_diag_len() / float(n_pts), pts)  # (N,)
        # per-voxel max (segment max) and the sampled set
        opa_max = torch.full((n_voxel,), -torch.inf, device=dev).scatter_reduce(0, flat_idx, opacity, "amax")
        sampled = torch.zeros((n_voxel,), dtype=torch.bool, device=dev).index_fill(0, flat_idx, True)
        old = opafield.reshape(-1)
        new = torch.maximum(old * self.get_optim_cfgs("ema_optim_decay"), opa_max)
        new = torch.where(sampled & (old >= 0), new, old)
        opafield = new.reshape(opafield.shape)
        bitfield = vol.update_bitfield_by_opafield(bitfield, opafield, threshold=self.get_optim_cfgs("opa_thres"),
                                                   ops="overwrite")
        return {"bitfield": bitfield, "opafield": opafield}
