"""Foreground model with a pluggable object bound: sampling, compaction of
the valid samples into one stream, and compositing on that stream.

Counterpart of ``arcnerf_tpu/models/fg_model.py`` (``__call__``,
``_compact_sel_aux``, ``_compact_budget``, ``fused_render_by_mask_pts``,
``update_values_for_invalid_rays``), at inference and in training. The
training draws (sample jitter, sigma noise) come from a ``torch.Generator``
passed down from the trainer. The dense scatter-back path
(``get_sigma_radiance_by_mask_pts`` + ``ray_marching``) is not ported.
"""

import torch

from ..render.ray_helper import march_group, segment_march
from ..utils.cfgs import get_value_from_cfgs_field
from .base_3d_model import Base3dModel
from .base_modules.obj_bound import build_obj_bound


class FgModel(Base3dModel):
    """Foreground model; subclasses implement _forward over the samples."""

    def __init__(self, cfgs):
        super().__init__(cfgs)
        self.obj_bound, self.obj_bound_type = build_obj_bound(cfgs.model)

    def get_obj_bound(self):
        return self.obj_bound

    def init_bound_state(self, device=None):
        return self.obj_bound.init_state(device)

    def get_render_cfgs(self, key=None):
        obj_bound = get_value_from_cfgs_field(self.cfgs.model, "obj_bound")
        params = {
            "bkg_color": get_value_from_cfgs_field(obj_bound, "bkg_color", [0.0, 0.0, 0.0]),
            "depth_far": get_value_from_cfgs_field(obj_bound, "depth_far", 10.0),
            "max_allowance": get_value_from_cfgs_field(obj_bound, "log_max_allowance", -1),
            "eval_max_pts_per_ray": get_value_from_cfgs_field(obj_bound, "eval_max_pts_per_ray", None),
        }
        if obj_bound is None:
            params["bkg_color"] = [1.0, 1.0, 1.0]
        if params["max_allowance"] > 0:
            params["max_allowance"] = 1 << params["max_allowance"]
        return params if key is None else params[key]

    # ------------------------------------------------------------- sampling
    def get_near_far_from_rays(self, inputs, bound_state=None):
        return self.obj_bound.get_near_far_from_rays(
            bound_state or {}, inputs, near_hardcode=self.get_ray_cfgs("near"),
            far_hardcode=self.get_ray_cfgs("far"), bounding_radius=self.get_ray_cfgs("bounding_radius"))

    def use_scattered_masks(self):
        """Ladder-order (unsorted) occupancy masks: density models without
        importance upsampling or a sigma-blend background."""
        if self.sigma_reverse() or self.get_ray_cfgs("n_importance") > 0:
            return False
        bkg = get_value_from_cfgs_field(self.cfgs.model, "background", None)
        return not (bkg is not None and get_value_from_cfgs_field(bkg, "bkg_blend", "rgb") == "sigma")

    # -------------------------------------------------------------- forward
    def forward(self, inputs, inference_only=True, get_progress=False, bound_state=None, generator=None):
        """Render flat rays: inputs rays_o/rays_d (B, 3) (+ bkg_color (B, 3)).
        Returns per-ray rgb/depth/mask (suffixed ``_coarse`` in training)
        and n_valid_pts. In training (``inference_only=False``) the zvals
        are jittered when rays.perturb is set, and sigma noised when
        rays.noise_std > 0, with draws from ``generator``."""
        if get_progress:
            raise NotImplementedError("per-sample progress outputs are not ported yet (ROADMAP Queue 1, item 3)")
        rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
        near, far, mask_rays = self.get_near_far_from_rays(inputs, bound_state)
        near, far = near.detach(), far.detach()
        n_coarse = self.get_ray_cfgs("n_sample")
        if inference_only:
            # the inference ladder may be coarser than training's (eval_n_sample)
            n_coarse = int(self.obj_bound.get_optim_cfgs().get("eval_n_sample") or n_coarse)
        zvals, mask_pts = self.obj_bound.get_zvals_from_near_far(
            bound_state or {}, near, far, n_coarse, inference_only, self.get_ray_cfgs("inverse_linear"),
            self.get_ray_cfgs("perturb"), generator, rays_o=rays_o, rays_d=rays_d,
            keep_order=self.use_scattered_masks())
        inputs = dict(inputs, zvals=zvals.detach(), mask_pts=mask_pts)
        if mask_pts is not None:
            ray_has_pts = mask_pts.any(dim=1)
            mask_rays = ray_has_pts if mask_rays is None else (mask_rays & ray_has_pts)

        output = self._forward(inputs, inference_only, generator)
        if mask_rays is not None:
            output = self.update_values_for_invalid_rays(output, mask_rays, inputs.get("bkg_color"))
        if mask_pts is not None:
            output["n_valid_pts"] = mask_pts.sum()
        return output

    def _forward(self, inputs, inference_only=True, generator=None):
        raise NotImplementedError("implement _forward in the concrete model")

    # ----------------------------------------------------------- compaction
    @staticmethod
    def _compact_sel_aux(mask_pts, budget):
        """Flat indices of the first ``budget`` valid samples in ray-major
        order, plus the segment geometry of that stream: ``off`` (B,)
        unclipped exclusive start rank per ray and ``cnt`` (B,) in-stream
        count (clipped to the budget). Returns (sel, sel_valid, off, cnt).
        Same ``sel`` as the JAX row-gather form on the valid prefix; padding
        rows carry index 0 (consumers bound reads by off/cnt or sel_valid)."""
        n_rays, n_pts = mask_pts.shape
        total = n_rays * n_pts
        row = torch.cumsum(mask_pts.to(torch.int64), dim=1)  # (B, N) inclusive
        tot = row[:, -1]
        off = torch.cumsum(tot, dim=0) - tot
        # each valid slot lands at its global rank; the rest at a dump row
        rank = (row + off[:, None] - 1).reshape(-1)
        rank = torch.where(mask_pts.reshape(-1) & (rank < budget), rank, budget)
        sel = torch.zeros(budget + 1, dtype=torch.int64, device=mask_pts.device)
        sel = sel.scatter_(0, rank, torch.arange(total, device=mask_pts.device))[:budget]
        sel_valid = torch.arange(budget, device=mask_pts.device) < tot.sum()
        cnt = torch.minimum((budget - off).clamp_min(0), tot)
        return sel, sel_valid, off, cnt

    def _compact_budget(self, n_rays, inference_only):
        """Compaction budget (obj_bound.log_max_allowance), shrunk at
        inference to the per-ray sample cap when one is set."""
        budget = self.get_render_cfgs("max_allowance")
        if inference_only and isinstance(budget, int) and budget > 0:
            cap = self.get_render_cfgs("eval_max_pts_per_ray")
            if cap:
                budget = min(budget, -(-(n_rays * int(cap)) // 1024) * 1024)
        return budget

    def fused_render_by_mask_pts(self, geo_net, radiance_net, rays_o, rays_d, zvals, mask_pts, inference_only=True,
                                 bkg_color=None, generator=None):
        """Compacted-stream render: evaluate sigma/radiance on the budgeted
        valid samples and composite them there (``segment_march``, kernels C
        and F on the card). Where the budget covers every sample the stream
        holds them all, which integrates exactly as the JAX package's dense
        path does (it switches to that path there). In training, sigma gets
        N(0, noise_std) noise from ``generator`` when rays.noise_std > 0.
        Returns {rgb, depth, mask}."""
        n_rays, n_pts = zvals.shape
        budget = self._compact_budget(n_rays, inference_only)
        if mask_pts is None or not isinstance(budget, int) or budget <= 0:
            raise NotImplementedError("the dense sample path (no occupancy mask or no log_max_allowance) is "
                                      "not ported yet (ROADMAP Queue 1, item 4)")
        budget = min(budget, n_rays * n_pts)
        sel, _, off, cnt = self._compact_sel_aux(mask_pts, budget)
        ray_id = sel // n_pts
        z_sel = zvals.reshape(-1)[sel]
        d_sel = rays_d[ray_id]
        pts_sel = rays_o[ray_id] + z_sel[:, None] * d_sel

        sigma_c, radiance_c = self._forward_pts_dir(geo_net, radiance_net, pts_sel, d_sel)
        noise = None
        noise_std = 0.0 if inference_only else float(self.get_ray_cfgs("noise_std") or 0.0)
        if noise_std > 0.0 and generator is not None:
            noise = torch.randn(sigma_c.shape, generator=generator, device=sigma_c.device) * noise_std
        # kernel C's lanes a ray: the serving cap keeps every segment short
        group = march_group(self.get_render_cfgs("eval_max_pts_per_ray") if inference_only else None)
        out = segment_march(sigma_c, radiance_c, z_sel, off, cnt, add_inf_z=self.get_ray_cfgs("add_inf_z"),
                            white_bkg=self.get_ray_cfgs("white_bkg"), bkg_color=bkg_color, noise=noise, group=group)
        out.pop("trans_end")
        return out

    # ----------------------------------------------------- invalid-ray fill
    def update_values_for_invalid_rays(self, output_valid, mask, rand_bkg_color=None):
        """Fill defaults on rays that miss the bound or keep no sample."""
        render_cfgs = self.get_render_cfgs()
        output = {}
        for k, v in output_valid.items():
            m = mask.reshape((mask.shape[0],) + (1,) * (v.ndim - 1))
            if k.startswith("rgb"):
                if rand_bkg_color is not None:
                    fill = torch.broadcast_to(rand_bkg_color, v.shape)
                else:
                    fill = torch.as_tensor(render_cfgs["bkg_color"], dtype=v.dtype, device=v.device).expand(v.shape)
                output[k] = torch.where(m, v, fill)
            elif k.startswith("depth"):
                output[k] = torch.where(m, v, float(render_cfgs["depth_far"]))
            elif k.startswith("mask"):
                output[k] = torch.where(m, v, 0.0)
            else:
                output[k] = v
        return output
