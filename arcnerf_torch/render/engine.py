"""Render engine: the exact, fast, interactive and windowed render tiers on
one device.

Counterpart of ``arcnerf_tpu/render/engine.py`` (``set_render_cap``,
``_chunk_for_mesh``, ``render_image``, ``_hit_prepass``, ``_count_prepass``,
``render_image_fast``, ``render_image_interactive``,
``render_image_windowed`` with ``_windowed_fused``, ``_refine_pixel_select``
and ``_bilinear_upsample``). Where the JAX engine scans a static budget of
padded ray chunks in one jitted dispatch over a device mesh, this one loops
over ray chunks in Python on one device. A tier selects its rays on the
device (the rank scatter of the JAX engine), reads the count of selected
rays (one scalar) and renders those rays alone, so no chunk is padded and
an empty pass of the windowed tier renders nothing. Images come back as
(H, W, ...) tensors on the device, stats as Python numbers under the JAX
keys. The multi-device host path of the fast tier (``fused=False``) is not
ported. On the card, where the exact tier's chunks take no host read (the
fused sampler's stream, ``FgModel.fuses_sampling``), a frame's chunk loop
runs through a ``FrameGraph``: one CUDA graph a frame shape, replayed frame
after frame; ``RenderEngine.eager`` asks for the eager loop instead. While
tracing is on (``utils.profiler``) each tier's call is one ``render.frame``
span around its prepass, pass and chunk spans (a replay's
``render.replay``), and every read of a device count goes through
``profiler.host_read``.
The prepasses ask the bound for its occupancy ladder (``VolumeBound.ladder``)
at the model's serving length; a windowed frame walks it once.
"""

import contextlib
import functools

import torch

from ..models.base_modules import encoding
from ..utils import profiler
from ..utils.cfgs import get_value_from_cfgs_field
from . import ray_helper
from .frame_graph import FrameGraph

# the sample keys a render feeds the model, per ray
RAY_KEYS = ("rays_o", "rays_d", "bounds")
# rays a prepass tests at a time: its (rays, ladder) grids stay near 1 GB
PREPASS_RAYS = 1 << 16
# frame shapes whose graphs the exact tier keeps (the oldest goes first)
MAX_FRAME_GRAPHS = 4


def _bilinear_upsample(img, h, w, off, scale):
    """Upsample an (hs, ws, ...) subgrid, whose pixel i is full-resolution
    pixel off + i * scale, back to (h, w, ...): bilinear, edge-clamped,
    computed in float64 as the JAX package computes it."""
    hs, ws = img.shape[:2]
    dev = img.device
    ys = (torch.arange(h, dtype=torch.float64, device=dev) - off) / scale
    xs = (torch.arange(w, dtype=torch.float64, device=dev) - off) / scale
    y0 = torch.floor(ys).long().clamp(0, hs - 1)
    x0 = torch.floor(xs).long().clamp(0, ws - 1)
    y1 = (y0 + 1).clamp_max(hs - 1)
    x1 = (x0 + 1).clamp_max(ws - 1)
    extra = (1,) * (img.ndim - 2)
    wy = (ys - y0).clamp(0.0, 1.0).reshape((h, 1) + extra)
    wx = (xs - x0).clamp(0.0, 1.0).reshape((1, w) + extra)
    src = img.double()
    top = src[y0][:, x0] * (1.0 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1.0 - wx) + src[y1][:, x1] * wx
    return (top * (1.0 - wy) + bot * wy).to(img.dtype)


def _hit_budget(n, hit_frac, chunk_rays):
    """A ray budget of ``hit_frac * n`` rays rounded up to whole chunks, at
    least one."""
    return max(chunk_rays, int(-(-(n * hit_frac) // chunk_rays)) * chunk_rays)


def _rank_select(flags, budget):
    """The indices of the first ``budget`` set flags in order, by a scatter
    of each set flag at its rank (the JAX engine's form), and their count
    before the budget clips it (a device scalar)."""
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    rank = torch.where(flags, rank.clamp(0, budget), budget)
    sel = torch.zeros(budget + 1, dtype=torch.int64, device=flags.device)
    sel = sel.scatter_(0, rank, torch.arange(n, device=flags.device))[:budget]
    return sel, flags.sum()


def _chunk_entries():
    """The chunk's kernel entries as their modules hold them now. A caller
    may wrap one to watch each call (the encoding's points, a march's
    stream); a graph replay calls no Python and would hide them. Such a
    caller should say so through ``RenderEngine.eager``; until the
    benchmark's work count does, a wrapped entry is taken as that request."""
    return encoding.hash_encode, ray_helper.segment_march_fwd


_OWN_ENTRIES = _chunk_entries()


def _frame(tier):
    """A render tier's call as one ``render.frame`` span."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with profiler.span("render.frame", tier=tier):
                return fn(*args, **kwargs)

        return traced

    return wrap


class RenderEngine:
    """The render tiers of ``model`` with the occupancy ``bound_state`` on
    ``device``."""

    def __init__(self, model, cfgs, bound_state, device):
        self.model = model
        self.cfgs = cfgs
        self.bound_state = bound_state
        self.device = torch.device(device)
        self.last_n_valid_pts = 0  # valid (capped) samples in the last render
        self.graphs = {}  # frame key -> FrameGraph
        self._graphs_read = None  # the addresses of the tensors the graphs read
        self._eager = False  # inside ``eager``

    @contextlib.contextmanager
    def eager(self):
        """The exact tier renders through the eager chunk loop inside the
        block, for a caller who watches each chunk's calls (a replay calls
        no Python). Counted as ``render.eager`` where a graph would have
        rendered the frame."""
        was, self._eager = self._eager, True
        try:
            yield
        finally:
            self._eager = was

    def set_render_cap(self, cap, n_sample=None, window=False):
        """Set the inference per-ray sample cap (obj_bound.eval_max_pts_per_ray;
        None renders every sample), an inference-only coarse ladder
        (obj_bound.eval_n_sample; None keeps the training ladder) and the
        window mode (obj_bound.eval_cap_window: the cap becomes the window
        of ``render_image_windowed``), then refresh the bound, which reads
        them once when built. Drops the frame graphs, which bake them in."""
        self.graphs.clear()
        fg = self.model.fg_model
        obj_bound = get_value_from_cfgs_field(fg.cfgs.model, "obj_bound", None)
        if obj_bound is None:
            return
        setattr(obj_bound, "eval_max_pts_per_ray", cap)
        setattr(obj_bound, "eval_n_sample", n_sample)
        setattr(obj_bound, "eval_cap_window", bool(window))
        fg.get_obj_bound().refresh_optim_cfgs()

    # ------------------------------------------------------------- helpers
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

    def _feed(self, sample):
        """The sample's ray tensors (RAY_KEYS) as f32 on the device."""
        return {k: torch.as_tensor(sample[k], dtype=torch.float32).to(self.device)
                for k in RAY_KEYS if sample.get(k) is not None}

    def _graphs_on(self):
        """Whether the exact tier renders its chunk loop through
        ``FrameGraph``: the device captures graphs and the model samples
        through the fused sampler (no host read in a chunk), and no caller
        asked for the eager loop (``eager``, or a wrapped kernel entry of
        the chunk; counted as ``render.eager``). Drops the graphs where a
        parameter, buffer or occupancy tensor they read was replaced."""
        fg_state = self.bound_state.get("fg", self.bound_state)
        if not (FrameGraph.captures_on(self.device) and self.model.fg_model.fuses_sampling(fg_state)):
            return False
        if self._eager or _chunk_entries() != _OWN_ENTRIES:
            profiler.count("render.eager", 1)
            return False
        state = [v for v in fg_state.values() if torch.is_tensor(v)]
        read = tuple(t.data_ptr() for t in (*self.model.parameters(), *self.model.buffers(), *state))
        if read != self._graphs_read:
            self.graphs.clear()
            self._graphs_read = read
        return True

    def _frame_graph(self, feed, chunk_rays):
        key = (chunk_rays,) + tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(feed.items()))
        graph = self.graphs.get(key)
        if graph is None:
            if len(self.graphs) >= MAX_FRAME_GRAPHS:
                self.graphs.pop(next(iter(self.graphs)))
            graph = self.graphs[key] = FrameGraph(self, feed, chunk_rays)
        return graph

    def _chunk_loop(self, feed, chunk_rays, cap_offset=None):
        """Render the rays of ``feed`` (flat (n, ...) tensors) in chunks;
        returns (the per-ray outputs as flat (n, ...) tensors, each chunk's
        written into its rows; each chunk's valid samples (n_chunks,)).
        ``cap_offset`` is the window of every chunk."""
        n = feed["rays_o"].shape[0]
        flat, n_valid = None, torch.zeros(-(-n // chunk_rays), dtype=torch.int64, device=self.device)
        for i, s in enumerate(range(0, n, chunk_rays)):
            chunk = {k: v[None, s:s + chunk_rays] for k, v in feed.items()}
            m = chunk["rays_o"].shape[1]
            if cap_offset is not None:
                chunk["cap_offset"] = cap_offset
            with profiler.span("render.chunk", rays=m):
                out = self.model(chunk, inference_only=True, bound_state=self.bound_state)
                if "n_valid_pts" in out:
                    n_valid[i] = out["n_valid_pts"]
                if flat is None:
                    flat = {k: v.new_empty((n,) + v.shape[2:]) for k, v in out.items()
                            if v.ndim >= 2 and v.shape[1] == m}
                for k, v in flat.items():
                    v[s:s + m].copy_(out[k][0])
        return flat, n_valid

    def _render_rays(self, feed, chunk_rays, cap_offset=None):
        """The eager chunk loop over ``feed``; returns its per-ray outputs
        as flat (n, ...) tensors."""
        flat, n_valid = self._chunk_loop(feed, chunk_rays, cap_offset)
        self.last_n_valid_pts = n_valid.sum()
        return flat

    def _miss_rgb(self, bkg_color):
        """The colour of a ray that hits nothing: the fed background, else
        white under rays.white_bkg, else black."""
        if bkg_color is not None:
            return torch.as_tensor(bkg_color, dtype=torch.float32).to(self.device)
        white = self.model.fg_model.get_ray_cfgs("white_bkg")
        return torch.full((3,), 1.0 if white else 0.0, device=self.device)

    # -------------------------------------------------------- exact render
    @torch.inference_mode()
    @_frame("exact")
    def render_image(self, sample, chunk_rays=None, bkg_color=None):
        """Render every ray of a dataset sample; returns a dict of
        (H, W, ...) tensors on the device. ``bkg_color`` (3,) composites a
        background at render time."""
        chunk_rays = self._chunk_for_mesh(chunk_rays)
        h, w = int(sample["H"]), int(sample["W"])
        feed = self._feed(sample)
        if bkg_color is not None:
            feed["bkg_color"] = self._miss_rgb(bkg_color).expand(feed["rays_o"].shape[0], 3)
        if self._graphs_on():
            flat, n_valid = self._frame_graph(feed, chunk_rays).run(feed)
            self.last_n_valid_pts = n_valid.sum()
        else:
            flat = self._render_rays(feed, chunk_rays)
        return {k: v.reshape((h, w) + v.shape[1:]) for k, v in flat.items()}

    # --------------------------------------------------------- prepasses
    @torch.inference_mode()
    def _prepass(self, kind, bound_state, rays_o, rays_d, n_probe=0):
        """One ``render.prepass`` span over PREPASS_RAYS rays at a time: the
        bound's box hit and, where the sampler culls by occupancy (the only
        sampler for which the bitfield is part of the render), the occupancy
        of its serving ladder (``n_probe <= 0``) or of ``n_probe`` evenly
        spaced points, by ``kind``: "hit" any, "count" the sum."""
        fg = self.model.fg_model
        fg_state = bound_state.get("fg", bound_state)
        bound = fg.get_obj_bound()
        ladder = bound.occupancy_ladder(fg_state)
        outs = []
        with profiler.span("render.prepass", kind=kind):
            for s in range(0, rays_o.shape[0], PREPASS_RAYS):
                o, d = rays_o[s:s + PREPASS_RAYS], rays_d[s:s + PREPASS_RAYS]
                near, far, hit = bound.get_near_far_from_rays(fg_state, {"rays_o": o, "rays_d": d})
                if ladder:
                    if n_probe <= 0:
                        occ = bound.ladder(fg_state, o, d, near, far, fg._n_coarse(True))[1]
                    else:
                        t = torch.linspace(0.0, 1.0, n_probe, device=near.device)[None, :]
                        occ = bound.occupied(fg_state, o, d, near + (far - near) * t)
                    hit = hit & occ.any(1) if kind == "hit" else torch.where(hit, occ.sum(1, dtype=torch.int32), 0)
                outs.append(hit)
        return None if outs[0] is None else torch.cat(outs)

    def _hit_prepass(self, bound_state, rays_o, rays_d, n_probe=0):
        """(n,) bool: the rays that can hit anything: the bound's intersect
        and, where the sampler culls by occupancy, an occupancy probe along
        [near, far]. ``n_probe <= 0`` probes the sampler's own fix-step
        ladder, which is exact (hit == the sampler finds a valid sample ==
        ``_count_prepass(...) > 0``); a positive ``n_probe`` probes that
        many evenly spaced points. None when nothing culls a ray."""
        return self._prepass("hit", bound_state, rays_o, rays_d, n_probe)

    def _count_prepass(self, bound_state, rays_o, rays_d):
        """(n,) int32: each ray's valid samples on the sampler's own
        fix-step ladder (0 for rays that miss the bound), which sizes the
        windowed tier's passes; None when the bound has no occupancy."""
        if not self.model.fg_model.get_obj_bound().occupancy_ladder(bound_state.get("fg", bound_state)):
            return None
        return self._prepass("count", bound_state, rays_o, rays_d)

    def _hit_set(self, feed, n_probe):
        """The hit prepass over ``feed``'s rays; every ray where nothing culls."""
        hit = self._hit_prepass(self.bound_state, feed["rays_o"], feed["rays_d"], n_probe)
        return torch.ones(feed["rays_o"].shape[0], dtype=torch.bool, device=self.device) if hit is None else hit

    # -------------------------------------------------------- fast render
    def _fast_fused(self, feed, miss_rgb, n_probe, budget, chunk):
        """Prepass, select the first ``budget`` hit rays, render them in
        chunks, write them into the image over the miss fill (rgb the miss
        colour, the rest 0). Returns (flat images, hit count)."""
        n = feed["rays_o"].shape[0]
        sel, n_hit = _rank_select(self._hit_set(feed, n_probe), budget)
        n_hit = profiler.host_read(n_hit, "render.hit_count")
        m = min(n_hit, budget)
        # a frame with no hit still renders one ray, for the output keys
        rows = sel[:max(m, 1)]
        outs = self._render_rays({k: v[rows] for k, v in feed.items()}, chunk)
        imgs = {}
        with profiler.span("render.assemble"):
            for k, v in outs.items():
                if k == "rgb":
                    img = miss_rgb.to(v.dtype).expand(n, 3).clone()
                else:
                    img = v.new_zeros((n,) + v.shape[1:])
                img[sel[:m]] = v[:m]
                imgs[k] = img
        return imgs, n_hit

    @torch.inference_mode()
    @_frame("fast")
    def render_image_fast(self, sample, chunk_rays=None, bkg_color=None, hit_frac=0.5, n_probe=0, fused=None):
        """Render only the rays that can hit anything: the hit prepass
        selects up to ``hit_frac * n`` of them (rounded up to whole chunks),
        they render at the inference per-ray cap (``set_render_cap``), and
        every other ray takes the background. Returns (images, stats:
        hit_frac, budget_rays, clipped_rays - hit rays past the budget,
        which render as background). The port builds no background model,
        whose every ray the JAX engine renders exactly here instead."""
        if fused is False:
            raise NotImplementedError("the multi-device host path of render_image_fast (fused=False) is not "
                                      "ported yet (ROADMAP Queue 1, item 7)")
        chunk_rays = self._chunk_for_mesh(chunk_rays)
        h, w = int(sample["H"]), int(sample["W"])
        feed = self._feed(sample)
        n = feed["rays_o"].shape[0]
        budget = _hit_budget(n, hit_frac, chunk_rays)
        miss = self._miss_rgb(bkg_color)
        if bkg_color is not None:
            feed["bkg_color"] = miss.expand(n, 3)
        flat, n_hit = self._fast_fused(feed, miss, n_probe, budget, chunk_rays)
        imgs = {k: v.reshape((h, w) + v.shape[1:]) for k, v in flat.items()}
        return imgs, {"hit_frac": n_hit / max(n, 1), "budget_rays": budget, "clipped_rays": max(0, n_hit - budget)}

    @staticmethod
    def _subgrid(sample, h, w, scale):
        """The stride-``scale`` pixel subgrid of ``sample``'s rays, centred
        mid-stride -> (sub-sample, offset)."""
        off = scale // 2
        hs, ws = len(range(off, h, scale)), len(range(off, w, scale))
        sub = {"H": hs, "W": ws}
        for k in RAY_KEYS:
            if sample.get(k) is not None:
                arr = torch.as_tensor(sample[k])
                sub[k] = arr.reshape((h, w) + arr.shape[1:])[off::scale, off::scale].reshape((hs * ws,) + arr.shape[1:])
        return sub, off

    @torch.inference_mode()
    @_frame("interactive")
    def render_image_interactive(self, sample, scale=2, chunk_rays=None, bkg_color=None, hit_frac=0.5, n_probe=0):
        """Render a stride-``scale`` subgrid of the image's rays through the
        fast tier, then upsample every output bilinearly to the full frame.
        Returns (images at (H, W, ...), stats of the fast tier + scale,
        shaded_rays)."""
        h, w = int(sample["H"]), int(sample["W"])
        scale = max(1, int(scale))
        if scale == 1:
            return self.render_image_fast(sample, chunk_rays=chunk_rays, bkg_color=bkg_color, hit_frac=hit_frac,
                                          n_probe=n_probe)
        sub, off = self._subgrid(sample, h, w, scale)
        imgs_s, stats = self.render_image_fast(sub, chunk_rays=chunk_rays, bkg_color=bkg_color, hit_frac=hit_frac,
                                               n_probe=n_probe)
        imgs = {k: _bilinear_upsample(v, h, w, off, scale) for k, v in imgs_s.items()}
        return imgs, dict(stats, scale=scale, shaded_rays=sub["H"] * sub["W"])

    # -------------------------------------- transmittance-continuation render
    def _windowed_fused(self, feed, miss_rgb, hit_bkg, hit, n_hit, budget1, pass_budgets, chunk, cap, eps):
        """Pass 0 shades the first ``cap`` valid samples (the window) of the
        first ``budget1`` rays of the hit set ``hit`` (n,), of count ``n_hit``
        (None: read here). Pass p shades window p of the rays still alive -
        transmittance T above ``eps`` and every earlier window full -
        up to ``pass_budgets[p - 1]`` of them, each weighted by its carried
        T. Windows march with the pre-cap occupancy mask, so each sample's
        alpha is the full render's and the weighted sum telescopes: a ray
        that finishes within the passes renders exactly. An alive ray past a
        pass's budget retires (``clipped_alive`` counts it). Returns (flat
        images, hit count, rays alive at the end, clipped alive rays, alive
        rays entering each pass)."""
        n = feed["rays_o"].shape[0]
        sel, n_sel = _rank_select(hit, budget1)
        if n_hit is None:
            n_hit = profiler.host_read(n_sel, "render.hit_count")
        m1 = min(n_hit, budget1)
        miss_depth = float(self.model.fg_model.get_render_cfgs()["depth_far"])
        imgs = {"rgb": miss_rgb.expand(n, 3).clone(), "depth": torch.full((n,), miss_depth, device=self.device),
                "mask": torch.zeros(n, device=self.device)}
        if m1 == 0:
            return imgs, n_hit, 0, 0, [0] * len(pass_budgets)

        with profiler.span("render.pass", p=0):
            feed1 = {k: v[sel[:m1]] for k, v in feed.items()}
            out1 = self._render_rays(feed1, chunk, cap_offset=0)
            rgb, depth, mask = out1["rgb"], out1["depth"], out1["mask"]
            trans = torch.clamp(1.0 - mask, 0.0, 1.0)
            # a ray can have more samples only if its window came back full
            n_win = out1.get("n_win_pts")
            may_more = n_win >= cap if n_win is not None else torch.ones(m1, dtype=torch.bool, device=self.device)

        clipped, alive_counts = 0, []
        for p, budget2 in enumerate(pass_budgets, start=1):
            with profiler.span("render.pass", p=p):
                alive = (trans > eps) & may_more
                rank = torch.cumsum(alive.to(torch.int64), 0) - 1
                n_alive = profiler.host_read(alive.sum(), "render.alive")
                alive_counts.append(n_alive)
                clipped += max(n_alive - budget2, 0)
                may_more = may_more & ~(alive & (rank >= budget2))
                if n_alive == 0:
                    continue
                rows = torch.nonzero(alive & (rank < budget2))[:, 0]
                out2 = self._render_rays({k: v[rows] for k, v in feed1.items()}, chunk, cap_offset=p * cap)
                w2 = trans[rows]
                rgb[rows] += w2[:, None] * out2["rgb"]
                depth[rows] += w2 * out2["depth"]
                mask[rows] += w2 * out2["mask"]
                trans[rows] = w2 * torch.clamp(1.0 - out2["mask"], 0.0, 1.0)
                if "n_win_pts" in out2:
                    may_more[rows] = out2["n_win_pts"] >= cap

        with profiler.span("render.assemble"):
            if hit_bkg is not None:
                # the exact render composites T_end * bkg inside its march; the
                # windows run without a background and composite it once here
                rgb = rgb + trans[:, None] * hit_bkg
            if n_win is not None:
                # a hit ray with an empty first window fills as the exact
                # render's invalid rays: depth_far, and the miss colour
                empty = n_win <= 0
                depth = torch.where(empty, miss_depth, depth)
                if hit_bkg is None:
                    rgb = torch.where(empty[:, None], miss_rgb.to(rgb.dtype), rgb)
            for k, v in (("rgb", rgb), ("depth", depth), ("mask", mask)):
                imgs[k][sel[:m1]] = v
            n_alive_end = profiler.host_read(((trans > eps) & may_more).sum(), "render.alive_end")
        return imgs, n_hit, n_alive_end, clipped, alive_counts

    @torch.inference_mode()
    @_frame("windowed")
    def render_image_windowed(self, sample, n_pass=3, alive_frac=0.5, chunk_rays=None, bkg_color=None, hit_frac=0.5,
                              n_probe=0, scale=1, eps=1e-3, adaptive_budget=True, refine_frac=0.0,
                              pass_budget_rays=None, budget_rays=None):
        """Full-image transmittance-continuation render (``_windowed_fused``),
        exact up to ``eps`` for every ray that finishes within ``n_pass``
        windows. Needs ``set_render_cap(cap, window=True)`` first: the cap is
        the window. ``scale`` > 1 shades a stride-``scale`` subgrid and
        upsamples it; ``refine_frac`` > 0 then re-renders that share of the
        other pixels, those of the largest luminance gradient, at full
        resolution.

        The pass budgets come from one of three ladders:
        - calibrated: ``pass_budget_rays`` (a ray budget a pass, e.g. from
          an earlier frame's ``alive_per_pass``), with pass 0's budget from
          ``budget_rays`` or else from the hit count;
        - counted (``adaptive_budget``): from each ray's valid-sample count,
          a ray being alive entering pass p only if it has at least p * cap
          valid samples, so no budget clips an alive ray and passes no ray
          can reach are dropped;
        - geometric: pass 0 rides ``hit_frac * n`` rays, pass p
          ``alive_frac ** p`` of that.
        Ray budgets round up to powers of two of whole chunks (at least
        4096 rays). Returns (images, stats)."""
        fg = self.model.fg_model
        if fg.get_ray_cfgs("white_bkg"):
            # a background composited inside each pass's march breaks the
            # T-weighted composition: render exactly instead
            imgs = self.render_image(sample, chunk_rays=chunk_rays, bkg_color=bkg_color)
            return imgs, {"fallback": "bkg-owning model"}
        bound = fg.get_obj_bound()
        if bound.window(0, inference_only=True) is None or not bound.get_optim_cfgs().get("eval_max_pts_per_ray"):
            raise RuntimeError("call set_render_cap(cap, window=True) before render_image_windowed")
        cap = int(bound.get_optim_cfgs("eval_max_pts_per_ray"))
        h, w = int(sample["H"]), int(sample["W"])
        scale = max(1, int(scale))
        kwargs = dict(n_pass=n_pass, alive_frac=alive_frac, chunk_rays=chunk_rays, bkg_color=bkg_color,
                      n_probe=n_probe, eps=eps, adaptive_budget=adaptive_budget)
        if scale > 1:
            sub, off = self._subgrid(sample, h, w, scale)
            imgs_s, stats = self.render_image_windowed(sub, hit_frac=hit_frac, pass_budget_rays=pass_budget_rays,
                                                       budget_rays=budget_rays, **kwargs)
            imgs = {k: _bilinear_upsample(v, h, w, off, scale) for k, v in imgs_s.items()}
            stats = dict(stats, scale=scale, shaded_rays=sub["H"] * sub["W"])
            if refine_frac > 0.0:
                ridx = self._refine_pixel_select(imgs["rgb"], h, w, off, scale, refine_frac)
                if ridx.numel():
                    rsub = {"H": 1, "W": int(ridx.numel())}
                    for k in RAY_KEYS:
                        if sample.get(k) is not None:
                            rsub[k] = torch.as_tensor(sample[k], dtype=torch.float32).to(self.device)[ridx]
                    rimgs, rstats = self.render_image_windowed(rsub, hit_frac=1.0, **kwargs)
                    for k in imgs:
                        if k in rimgs:
                            flat = imgs[k].reshape((h * w,) + imgs[k].shape[2:])
                            flat[ridx] = rimgs[k].reshape((ridx.numel(),) + imgs[k].shape[2:])
                    stats = dict(stats, refined_rays=int(ridx.numel()), refine_hit_frac=rstats.get("hit_frac"))
            return imgs, stats

        chunk_rays = self._chunk_for_mesh(chunk_rays)
        feed = self._feed(sample)
        n = feed["rays_o"].shape[0]
        n_chunks_max = -(-n // chunk_rays)

        def pow2_chunks(count):
            need, c = max(1, -(-count // chunk_rays)), 1
            while c < need:
                c *= 2
            return min(c, n_chunks_max)

        def ray_budgets(counts):
            """Ray budgets -> power-of-two ray budgets, at least one chunk of
            at most 4096 rays, at most every chunk; up to the first empty."""
            min_chunk, out = min(4096, chunk_rays), []
            for b in counts:
                if b <= 0:
                    break
                budget_p = min_chunk
                while budget_p < b:
                    budget_p *= 2
                budget_p = min(budget_p, n_chunks_max * chunk_rays)
                chunk_p = min(chunk_rays, budget_p)
                out.append(budget_p // chunk_p * chunk_p)
            return tuple(out)

        pass_budgets, hit, n_hit = None, None, None  # one prepass a frame: its hit set goes on to the passes
        if pass_budget_rays is not None:
            if budget_rays is not None:
                n_chunks1 = max(1, min(n_chunks_max, -(-int(budget_rays) // chunk_rays)))
            else:
                hit = self._hit_set(feed, n_probe)
                n_hit = profiler.host_read(hit.sum(), "render.hit_count")
                n_chunks1 = pow2_chunks(n_hit)
            pass_budgets = ray_budgets(pass_budget_rays)
        elif adaptive_budget:
            counts = self._count_prepass(self.bound_state, feed["rays_o"], feed["rays_d"])
            if counts is None:
                n_chunks1 = n_chunks_max
            else:
                # rays with at least p * cap valid samples, for p = 0 .. n_pass - 1
                full = torch.bincount((counts // cap).clamp_max(n_pass).long(), minlength=n_pass + 1)
                at_least = profiler.host_read(full.flip(0).cumsum(0).flip(0), "render.ladder", torch.Tensor.tolist)
                hit = counts > 0  # the hit prepass's set on the same ladder
                n_hit = profiler.host_read(hit.sum(), "render.hit_count")
                n_chunks1 = pow2_chunks(n_hit)
                pass_budgets = ray_budgets(at_least[1:n_pass])
                if n_probe > 0:  # the passes take the probe's set instead
                    hit = n_hit = None
        else:
            n_chunks1 = _hit_budget(n, hit_frac, chunk_rays) // chunk_rays
        if hit is None:
            hit = self._hit_set(feed, n_probe)
        budget1 = n_chunks1 * chunk_rays
        if pass_budgets is None:
            # alive rays drain geometrically
            pass_budgets = tuple(max(1, int(-(-(n_chunks1 * alive_frac**p) // 1))) * chunk_rays
                                 for p in range(1, n_pass))

        # the background is not fed to the model: it is composited once, at the end
        miss = self._miss_rgb(bkg_color) if bkg_color is not None else torch.zeros(3, device=self.device)
        hit_bkg = miss if profiler.host_read((miss != 0.0).any(), "render.background", bool) else None
        flat, n_hit, n_alive_end, clipped, alive = self._windowed_fused(feed, miss, hit_bkg, hit, n_hit, budget1,
                                                                        pass_budgets, chunk_rays, cap, float(eps))
        imgs = {k: v.reshape((h, w) + v.shape[1:]) for k, v in flat.items()}
        stats = {"hit_frac": n_hit / max(n, 1), "budget_rays": budget1, "hit_clipped": max(0, n_hit - budget1),
                 "pass_budget_rays": pass_budgets, "alive_per_pass": tuple(alive), "n_pass": n_pass, "cap": cap,
                 "alive_at_end": n_alive_end, "clipped_alive": clipped}
        return imgs, stats

    @staticmethod
    def _refine_pixel_select(rgb, h, w, off, scale, refine_frac):
        """The flat indices of ``int(refine_frac * h * w)`` pixels off the
        subgrid, those of the largest luminance gradient in the upsampled
        frame (ties broken by index). -> (k,) int64 tensor."""
        lum = rgb.float()
        if lum.ndim == 3:
            lum = lum @ torch.tensor([0.299, 0.587, 0.114], device=lum.device)
        gy = (lum - torch.cat([lum[:1], lum[:-1]], 0)).abs()
        gx = (lum - torch.cat([lum[:, :1], lum[:, :-1]], 1)).abs()
        score = (gy + gx).reshape(-1)
        onsub = torch.zeros((h, w), dtype=torch.bool, device=lum.device)
        onsub[off::scale, off::scale] = True
        score = torch.where(onsub.reshape(-1), -1.0, score)
        k = int(refine_frac * h * w)
        if k <= 0:
            return torch.zeros(0, dtype=torch.int64, device=lum.device)
        # exactly k indices: the refine render's size is frame-stable
        return torch.sort(score, descending=True, stable=True).indices[:k]
