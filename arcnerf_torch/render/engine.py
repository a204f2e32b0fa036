"""Render engine: exact full-image rendering on one device.

Counterpart of ``render_image`` and ``_chunk_for_mesh`` in
``arcnerf_tpu/render/engine.py``. Where the JAX engine scans padded chunks
in one dispatch over a device mesh, this one loops over ray chunks in
Python on one device; chunks need no padding. The fast, interactive and
windowed tiers are not ported yet.
"""

import torch


class RenderEngine:
    """Full-image renders of ``model`` with a fixed ``bound_state`` on ``device``."""

    def __init__(self, model, cfgs, bound_state, device):
        self.model = model
        self.cfgs = cfgs
        self.bound_state = bound_state
        self.device = torch.device(device)
        self.last_n_valid_pts = 0  # valid (capped) samples in the last render

    def _chunk_for_mesh(self, chunk_rays=None):
        """Rays per chunk: the model's chunk_rays (at most 16384), capped so
        that chunk * per-ray cap fits the point budget - past it, prefix
        compaction would drop the tail rays' samples."""
        if chunk_rays is None:
            chunk_rays = min(int(self.model.get_chunk_rays()), 16384)
        fg = self.model.fg_model
        cap = fg.get_obj_bound().get_optim_cfgs().get("eval_max_pts_per_ray")
        pt_budget = fg.get_render_cfgs("max_allowance")
        if cap and isinstance(pt_budget, int) and pt_budget > 0:
            chunk_rays = min(chunk_rays, pt_budget // int(cap))
        return max(1, chunk_rays)

    @torch.inference_mode()
    def render_image(self, sample, chunk_rays=None, bkg_color=None):
        """Render every ray of a dataset sample; returns a dict of
        (H, W, ...) tensors on the device. ``bkg_color`` (3,) composites a
        background at render time."""
        chunk_rays = self._chunk_for_mesh(chunk_rays)
        h, w = int(sample["H"]), int(sample["W"])
        rays_o = torch.as_tensor(sample["rays_o"], dtype=torch.float32).to(self.device)
        rays_d = torch.as_tensor(sample["rays_d"], dtype=torch.float32).to(self.device)
        n = rays_o.shape[0]
        bkg = None
        if bkg_color is not None:
            bkg = torch.as_tensor(bkg_color, dtype=torch.float32, device=self.device).expand(n, 3)
        outs, n_valid = [], torch.zeros((), dtype=torch.int64, device=self.device)
        for s in range(0, n, chunk_rays):
            feed = {"rays_o": rays_o[None, s:s + chunk_rays], "rays_d": rays_d[None, s:s + chunk_rays]}
            if bkg is not None:
                feed["bkg_color"] = bkg[None, s:s + chunk_rays]
            out = self.model(feed, inference_only=True, bound_state=self.bound_state)
            n_valid += out.pop("n_valid_pts", 0)
            outs.append({k: v[0] for k, v in out.items() if v.ndim >= 2 and v.shape[1] == feed["rays_o"].shape[1]})
        self.last_n_valid_pts = n_valid
        return {k: torch.cat([o[k] for o in outs]).reshape((h, w) + outs[0][k].shape[1:]) for k in outs[0]}
