"""Foreground model with a pluggable object bound: sampling, compaction of
the valid samples into one stream, and compositing on that stream.

Counterpart of ``arcnerf_tpu/models/fg_model.py`` (``__call__`` with its
window mode, ``_compact_sel_aux``, ``_compact_sel``, ``_compact_budget``,
``get_sigma_radiance_by_mask_pts``, ``fused_render_by_mask_pts``,
``update_values_for_invalid_rays``), at inference and in training. The
training draws (sample jitter, sigma noise) come from a ``torch.Generator``
passed down from the trainer. Where the bound walks its fix-step occupancy
ladder, ``forward`` samples and compacts in one (``sample_compact``, a
kernel on the card) and builds no (rays, samples) grid; for an SDF model
it writes the model's sections. Surface rendering is not ported.
"""

import torch

from ..geometry.transformation import normalize
from ..render.ray_helper import march_group, segment_march
from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.device_consts import device_constant
from .base_3d_model import Base3dModel
from .base_modules.obj_bound import build_obj_bound
from .base_modules.sample_compact import compact_sel_aux, gather_stream, sample_count, sample_write


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
            "normal": get_value_from_cfgs_field(obj_bound, "normal", [0.0, 1.0, 0.0]),
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

    def fuses_sampling(self, bound_state, get_progress=False, cap_offset=None):
        """Whether ``forward`` samples and compacts in one
        (``sample_compact``, a kernel on the card): the bound walks its
        fix-step occupancy ladder, the masks are scattered (or the model
        takes an SDF's sections), a point budget applies, and neither a
        window (``cap_offset``) nor progress outputs are asked for.
        Everything else needs the (rays, n_pts) grid."""
        budget = self.get_render_cfgs("max_allowance")
        return (self.obj_bound.occupancy_ladder(bound_state or {})
                and (self.use_scattered_masks() or self.stream_sections())
                and isinstance(budget, int) and budget > 0 and cap_offset is None and not get_progress)

    # -------------------------------------------------------------- forward
    def forward(self, inputs, inference_only=True, get_progress=False, bound_state=None, generator=None):
        """Render flat rays: inputs rays_o/rays_d (B, 3) (+ bkg_color (B, 3),
        + cap_offset, an int: the window of the transmittance-continuation
        render). Returns per-ray rgb/depth/mask (suffixed ``_coarse`` in
        training), n_valid_pts, the per-sample progress_* tensors with
        ``get_progress`` and, in window mode, n_win_pts (B,), the samples in
        each ray's window. In training (``inference_only=False``) the zvals
        are jittered when rays.perturb is set, and sigma noised when
        rays.noise_std > 0, with draws from ``generator``. Where
        ``fuses_sampling`` holds, ``_forward`` gets the compacted stream
        (inputs["stream"]) in place of the grid's zvals and masks."""
        bound_state = bound_state or {}
        if self.fuses_sampling(bound_state, get_progress, inputs.get("cap_offset")):
            inputs, mask_rays, n_valid = self._sample_stream(inputs, inference_only, bound_state, generator)
            output = self._forward(inputs, inference_only, get_progress, generator)
            output = self.update_values_for_invalid_rays(output, mask_rays, inputs.get("bkg_color"))
            output["n_valid_pts"] = n_valid
            if inference_only and profiler.active():  # training counts its steps outside the captured step
                self.count_stream(n_valid, inputs["rays_o"].shape[0])
            return output

        rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
        with profiler.span("model.sample"):
            near, far, mask_rays = self.get_near_far_from_rays(inputs, bound_state)
            near, far = near.detach(), far.detach()
            zvals, mask_pts = self.obj_bound.get_zvals_from_near_far(
                bound_state, near, far, self._n_coarse(inference_only), inference_only,
                self.get_ray_cfgs("inverse_linear"), self.get_ray_cfgs("perturb"), generator, rays_o=rays_o,
                rays_d=rays_d, keep_order=self.use_scattered_masks(), cap_offset=inputs.get("cap_offset"))
            # window mode: (window mask, pre-cap mask); marching spans gaps with
            # the pre-cap mask, so consecutive windows compose exactly
            windowed = isinstance(mask_pts, tuple)
            inputs = dict(inputs, zvals=zvals.detach())
            if windowed:
                mask_pts, inputs["mask_march"] = mask_pts
            inputs["mask_pts"] = mask_pts
            inputs["mask_scattered"] = self.use_scattered_masks() and mask_pts is not None
            if mask_pts is not None:
                ray_has_pts = mask_pts.any(dim=1)
                mask_rays = ray_has_pts if mask_rays is None else (mask_rays & ray_has_pts)

        output = self._forward(inputs, inference_only, get_progress, generator)
        if mask_rays is not None:
            # a window reports a partial integral: rays with an empty window
            # contribute exactly 0, with no background or depth fill
            output = self.update_values_for_invalid_rays(output, mask_rays, inputs.get("bkg_color"),
                                                         zero_fill=windowed)
        if mask_pts is not None:
            output["n_valid_pts"] = mask_pts.sum()
        if windowed:
            output["n_win_pts"] = mask_pts.sum(1, dtype=torch.int32)
        return output

    def _n_coarse(self, inference_only):
        """Ladder slots a ray: rays.n_sample, or at inference the bound's
        eval_n_sample where set (a coarser serving ladder)."""
        n_coarse = self.get_ray_cfgs("n_sample")
        if inference_only:
            n_coarse = int(self.obj_bound.get_optim_cfgs().get("eval_n_sample") or n_coarse)
        return n_coarse

    def _sample_stream(self, inputs, inference_only, bound_state, generator):
        """The fused sampler: the bound's near/far, the ladder, its
        occupancy, the cap and the compaction in two launches
        (``sample_count`` in the sample span, ``sample_write`` in the compact
        span). The jitter is the plain path's one draw, from ``generator``
        at the same point. Returns (inputs with the stream, mask_rays (B,),
        n_valid_pts)."""
        rays_o, rays_d = inputs["rays_o"], inputs["rays_d"]
        n_rays, n_pts = rays_o.shape[0], self._n_coarse(inference_only)
        budget = self.stream_budget(n_rays, inference_only)
        cap = self.obj_bound.get_optim_cfgs("eval_max_pts_per_ray") if inference_only else None
        with profiler.span("model.sample"):
            rand = None
            if self.get_ray_cfgs("perturb") and not inference_only and generator is not None:
                rand = torch.rand((n_rays, n_pts), generator=generator, dtype=rays_o.dtype, device=rays_o.device)
            plan = sample_count(self.obj_bound.get_obj_bound(), bound_state["bitfield"], rays_o, rays_d, n_pts,
                                budget, cap, rand, sections=self.stream_sections())
        with profiler.span("model.compact"):
            stream = sample_write(plan)
        return dict(inputs, stream=stream), plan["ray_has"], plan["n_valid"]

    def stream_budget(self, n_rays, inference_only):
        """The rows of the fused sampler's stream for a call of ``n_rays``
        rays: the compaction budget, at most every ladder slot."""
        return min(self._compact_budget(n_rays, inference_only), n_rays * self._n_coarse(inference_only))

    def count_stream(self, n_valid, n_rays):
        """Serving calls' counters on the fused sampler (tracing on): the
        valid samples ``n_valid`` (a device tensor, one count a call) each
        against the stream of a call of ``n_rays`` rays, and the calls. An
        eager call counts its own; a replay of the exact tier's frame graph
        counts its chunks' from their static counts."""
        profiler.count_compact(n_valid, self.stream_budget(n_rays, True))
        profiler.count("sample.fused", n_valid.numel())

    def stream_sections(self):
        """Whether the fused sampler writes an SDF's sections (SdfModel)
        rather than the samples."""
        return False

    def _forward(self, inputs, inference_only=True, get_progress=False, generator=None):
        raise NotImplementedError("implement _forward in the concrete model")

    # ----------------------------------------------------------- compaction
    _compact_sel_aux = staticmethod(compact_sel_aux)

    @staticmethod
    def _compact_sel(mask_pts, budget):
        """(sel, sel_valid) of ``_compact_sel_aux``: the flat indices of the
        first ``budget`` valid samples; rows past the valid count hold 0."""
        sel, sel_valid, _, _ = FgModel._compact_sel_aux(mask_pts, budget)
        return sel, sel_valid

    def _compact_budget(self, n_rays, inference_only):
        """Compaction budget (obj_bound.log_max_allowance), shrunk at
        inference to the per-ray sample cap when one is set."""
        budget = self.get_render_cfgs("max_allowance")
        if inference_only and isinstance(budget, int) and budget > 0:
            cap = self.get_render_cfgs("eval_max_pts_per_ray")
            if cap:
                budget = min(budget, -(-(n_rays * int(cap)) // 1024) * 1024)
        return budget

    def get_sigma_radiance_by_mask_pts(self, geo_net, radiance_net, rays_o, rays_d, zvals, mask_pts=None,
                                       inference_only=False):
        """sigma (B, N) and radiance (B, N, 3) at the (ray, sample) grid: at
        every sample, or, where a mask and a point budget below B * N apply,
        at the first ``budget`` valid samples only, scattered back into the
        grid (the other slots hold 0)."""
        n_rays, n_pts = zvals.shape
        total = n_rays * n_pts
        budget = self._compact_budget(n_rays, inference_only)
        if not (mask_pts is not None and isinstance(budget, int) and 0 < budget < total):
            pts = (rays_o[:, None, :] + zvals[..., None] * rays_d[:, None, :]).reshape(-1, 3)
            dirs = rays_d[:, None, :].expand(n_rays, n_pts, 3).reshape(-1, 3)
            sigma, radiance = self._forward_pts_dir(geo_net, radiance_net, pts, dirs)
            return sigma.reshape(n_rays, n_pts), radiance.reshape(n_rays, n_pts, 3)
        with profiler.span("model.compact"):
            sel, sel_valid = self._compact_sel(mask_pts, budget)
            _, pts_sel, d_sel = gather_stream(sel, zvals, rays_o, rays_d)
            if inference_only and profiler.active():  # training counts its steps outside the captured step
                profiler.count_compact(mask_pts.sum(), budget)
        sigma_c, radiance_c = self._forward_pts_dir(geo_net, radiance_net, pts_sel, d_sel)
        with profiler.span("model.compact"):
            # rows past the valid count go to a dump slot past the grid
            sel_safe = torch.where(sel_valid, sel, total)
            sigma = sigma_c.new_zeros(total + 1).index_copy(0, sel_safe, sigma_c)[:total]
            radiance = radiance_c.new_zeros((total + 1, 3)).index_copy(0, sel_safe, radiance_c)[:total]
        return sigma.reshape(n_rays, n_pts), radiance.reshape(n_rays, n_pts, 3)

    def fused_render_by_mask_pts(self, geo_net, radiance_net, rays_o, rays_d, zvals, mask_pts, inference_only=True,
                                 bkg_color=None, generator=None):
        """Compacted-stream render: evaluate sigma/radiance on the budgeted
        valid samples and composite them there (``segment_march``, kernels C
        and F on the card). Where the budget covers every sample the stream
        holds them all, which integrates exactly as the JAX package's dense
        path does (it switches to that path there). In training, sigma gets
        N(0, noise_std) noise from ``generator`` when rays.noise_std > 0.
        Returns {rgb, depth, mask}, or None where no mask or no point budget
        applies: the caller then takes the dense path."""
        n_rays, n_pts = zvals.shape
        budget = self._compact_budget(n_rays, inference_only)
        if mask_pts is None or not isinstance(budget, int) or budget <= 0:
            return None
        budget = min(budget, n_rays * n_pts)
        with profiler.span("model.compact"):
            sel, _, off, cnt = self._compact_sel_aux(mask_pts, budget)
            z_sel, pts_sel, d_sel = gather_stream(sel, zvals, rays_o, rays_d)
            if inference_only and profiler.active():  # training counts its steps outside the captured step
                profiler.count_compact(mask_pts.sum(), budget)
        stream = {"z": z_sel, "pts": pts_sel, "dirs": d_sel, "off": off, "cnt": cnt}
        return self.render_stream(geo_net, radiance_net, stream, inference_only, bkg_color, generator)

    def render_stream(self, geo_net, radiance_net, stream, inference_only=True, bkg_color=None, generator=None):
        """sigma and radiance on a compacted stream ({z, pts, dirs, off,
        cnt}, of ``gather_stream`` or ``sample_write``), composited along
        each ray (``segment_march``). Returns {rgb, depth, mask}."""
        sigma_c, radiance_c = self._forward_pts_dir(geo_net, radiance_net, stream["pts"], stream["dirs"])
        noise = None
        noise_std = 0.0 if inference_only else float(self.get_ray_cfgs("noise_std") or 0.0)
        if noise_std > 0.0 and generator is not None:
            noise = torch.randn(sigma_c.shape, generator=generator, device=sigma_c.device) * noise_std
        # kernel C's lanes a ray: the serving cap keeps every segment short
        group = march_group(self.get_render_cfgs("eval_max_pts_per_ray") if inference_only else None)
        with profiler.span("model.march"):
            out = segment_march(sigma_c, radiance_c, stream["z"], stream["off"], stream["cnt"],
                                add_inf_z=self.get_ray_cfgs("add_inf_z"),
                                white_bkg=self.get_ray_cfgs("white_bkg"), bkg_color=bkg_color, noise=noise,
                                group=group)
        out.pop("trans_end")
        return out

    # ----------------------------------------------------- invalid-ray fill
    def update_values_for_invalid_rays(self, output_valid, mask, rand_bkg_color=None, zero_fill=False):
        """Fill defaults on rays that miss the bound or keep no sample; with
        ``zero_fill`` (a window's partial integral) every output is 0 there."""
        render_cfgs = self.get_render_cfgs()
        output = {}
        for k, v in output_valid.items():
            if not torch.is_tensor(v):
                output[k] = v
                continue
            m = mask.reshape((mask.shape[0],) + (1,) * (v.ndim - 1))
            if zero_fill:
                output[k] = torch.where(m, v, 0.0)
            elif k.startswith("rgb"):
                if rand_bkg_color is not None:
                    fill = torch.broadcast_to(rand_bkg_color, v.shape)
                else:
                    fill = device_constant(render_cfgs["bkg_color"], v.dtype, v.device).expand(v.shape)
                output[k] = torch.where(m, v, fill)
            elif k.startswith("depth"):
                output[k] = torch.where(m, v, float(render_cfgs["depth_far"]))
            elif k.startswith("mask"):
                output[k] = torch.where(m, v, 0.0)
            elif k in ("normal", "normal_coarse", "normal_fine"):  # per ray; a stream's normal_pts is not
                fill = normalize(device_constant(render_cfgs["normal"], v.dtype, v.device))
                output[k] = torch.where(m, v, fill.expand(v.shape))
            elif k.startswith("progress"):
                output[k] = torch.where(m, v, 1.0 if "trans_shift" in k else 0.0)
            else:
                output[k] = v
        return output
