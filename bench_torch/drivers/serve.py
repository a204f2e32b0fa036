"""Serving: one client rendering the orbit frame after frame (a closed
loop) through one of the program's render tiers, at the tier's settings in
the workload file (``render``: tier exact | windowed, the cap, and the
tier's keyword arguments), over a white background. The reference knows
these two tiers' results (the fast and interactive tiers' selections and
upsampling it does not yet).

Set-up makes the served model's weights and the scene's occupancy grid
from the seed and the scene, the orbit's rays on the device, and renders
``warm_frames`` frames. The window renders pose after pose, each timed on
the host clock to a synchronize: ``frame_ms`` is the window's wall time
over the frames completed, ``frame_ms_p95`` the 95th percentile of every
frame's time. Frames drawn from the seed are kept for the check and
compared with the reference's render of the same camera once the window
has closed.
"""

import gc
import random
import statistics

import torch

from .. import check, port, roofline, scene, traffic
from ..reference import ngp

WHITE = (1.0, 1.0, 1.0)


class Serving:
    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.workload["traffic"]
        self.render_p = dict(p["render"])
        self.leaves = traffic.weights(ctx.model, p["weights"], ctx.seed, ctx.device)
        self.bits = scene.bitfield(ctx.spec.n_grid, ctx.spec.side).to(ctx.device)
        self.engine = port.engine(ctx.config, ctx.device, self.leaves, self.bits)
        tier = self.render_p.pop("tier")
        if tier not in ("exact", "windowed"):
            raise ValueError("the benchmark serves the exact and the windowed tiers, not {}".format(tier))
        cap = self.render_p.pop("cap")
        self.engine.set_render_cap(cap, window=tier == "windowed")
        self.tier, self.cap = tier, cap
        wh = p["orbit"]["wh"]
        self.h, self.w = int(wh[1]), int(wh[0])
        c2ws = traffic.orbit(p["orbit"], ctx.seed, ctx.device)
        self.rays = [scene.camera_rays(c, self.w, self.h) for c in c2ws]
        self.bkg = torch.tensor(WHITE, device=ctx.device)
        self.kept = []

    def pick(self, n):
        """The frames of the first ``n`` kept for the check, drawn from the
        seed."""
        k = min(int(self.ctx.workload["traffic"]["check_frames"]), n)
        self.keep_at = sorted(random.Random(traffic.derived_seed(self.ctx.seed, "check")).sample(range(n), k))

    def frame(self, i):
        o, d = self.rays[i % len(self.rays)]
        sample = {"rays_o": o, "rays_d": d, "H": self.h, "W": self.w}
        if self.tier == "exact":
            return self.engine.render_image(sample, bkg_color=self.bkg)
        return self.engine.render_image_windowed(sample, bkg_color=self.bkg, **self.render_p)[0]

    def setup(self):
        for i in range(int(self.ctx.workload["traffic"]["warm_frames"])):
            self.frame(i)
        self.ctx.sync()

    def keep(self, i, out):
        if len(self.kept) < len(self.keep_at) and i == self.keep_at[len(self.kept)]:
            self.kept.append((i, out["rgb"].clone(), out["depth"].clone()))

    @staticmethod
    def bad(out):
        """1 on the device where a frame holds a value that is not finite."""
        return (~torch.isfinite(out["rgb"])).any().int() + (~torch.isfinite(out["depth"])).any().int()

    def window(self, seconds):
        self.pick(int(self.ctx.workload["traffic"]["check_from"]))
        times, i, bad = [], 0, 0
        t0 = self.ctx.clock()
        while True:
            f0 = self.ctx.clock()
            out = self.frame(i)
            bad = bad + self.bad(out)
            self.ctx.sync()
            times.append(self.ctx.clock() - f0)
            self.keep(i, out)
            i += 1
            if self.ctx.clock() - t0 >= seconds:
                break
        wall = self.ctx.clock() - t0
        failed = int(bad)
        self.ctx.note("{} frames, {} kept for the check (frames {}); the last frame's last render call kept {} valid "
                      "samples".format(i, len(self.kept), [k[0] for k in self.kept],
                                       int(self.engine.last_n_valid_pts)))
        ms = sorted(t * 1e3 for t in times)
        p95 = statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else ms[0]
        k = max(1, len(times) // 4)
        self.ctx.note("frame ms: min {:.2f}, median {:.2f}, max {:.2f}; first quarter mean {:.2f}, last {:.2f}".format(
            ms[0], statistics.median(ms), ms[-1], 1e3 * statistics.mean(times[:k]), 1e3 * statistics.mean(times[-k:])))
        return {"frame_ms": wall * 1e3 / i, "frame_ms_p95": p95}, i, failed

    def traced(self, reading):
        n = int(self.ctx.workload["traffic"]["trace_frames"])
        self.pick(n)
        with self.ctx.profiled(reading):
            outs = [self.frame(i) for i in range(n)]
        failed = int(sum(self.bad(out) for out in outs))
        for i, out in enumerate(outs):
            self.keep(i, out)
        del outs
        # the same frames again, the encoding watched: the points each
        # chunk's call holds (its padding rows repeat one point) and the
        # table entries their corners reach
        rows = []
        unwrap = port.wrap_hash_encode(rows.append)
        try:
            for i in range(n):
                self.frame(i)
        finally:
            unwrap()
        reading["units"], reading["unit"] = n, "frame"
        reading["work"] = work_serve(self.ctx.spec, self.ctx.model, rows)
        self.ctx.note("traced frames: {:.0f} distinct points shaded a frame in {} encoding calls".format(
            reading["work"]["points"] / n, len(rows) / n))
        return n, failed

    def free(self):
        self.engine = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self):
        if not self.kept:
            raise RuntimeError("no frame was kept for the check")
        ctx = self.ctx
        # the exact tier's chunk times its cap fits the point budget, so no
        # chunk clips; the windowed tier composes the uncapped render
        cap = self.cap if self.tier == "exact" else None
        numbers = []
        for i, rgb, depth in self.kept:
            o, d = self.rays[i % len(self.rays)]
            ref_rgb, ref_depth, _ = ngp.render_frame(ctx.spec, self.leaves, self.bits, o, d, self.bkg, cap=cap,
                                                        block=4096, prec=ngp.F32)
            numbers.append(check.frame_numbers(rgb.reshape(-1, 3), depth.reshape(-1), ref_rgb, ref_depth))
        return check.worst(numbers)


def work_serve(spec, model, rows):
    """Each call's bound by layer, summed, and the forward MLP operations
    of its points."""
    hash_s = mlp_s = flops = pts_all = 0.0
    for xyz in rows:
        pts = float(torch.unique(xyz, dim=0).shape[0])
        entries = float(torch.unique(ngp.hash_entries(spec, xyz)).numel())
        hash_s += roofline.bound_s(*roofline.hash_fwd(model, pts, entries), roofline.F32_FLOP_S)
        mlp_s += roofline.bound_s(*roofline.mlp_fwd(model, pts), roofline.BF16_FLOP_S)
        flops += pts * roofline.mlp_flops_per_sample(model)
        pts_all += pts
    return {"hash_s": hash_s, "mlp_s": mlp_s, "mlp_flops": flops, "points": pts_all}


DRIVER = Serving
