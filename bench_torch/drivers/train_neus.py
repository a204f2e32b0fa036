"""NeuS-NGP training, as ``ArcNerfTrainer.train`` runs it: the NGP driver's
strides, cadences, window and traced run (``drivers/train.py``) for the
NeuS configurations, with their own leaves, weights, reference
(``reference/neus.py``) and work.

Set-up builds one trainer over the benchmark's views and weights (the
table uniform in +-table_range, the geometry net as its geometric init
draws it, the radiance net as the NGP cells draw theirs, inv_s at its
initial value), gives its occupancy state the benchmark's grid and runs
the checked occupancy update, returns the opacity field to 0, then runs
three steps, one call each, at the window's bucket (``check_rays``): the
check follows them. Then strides up to ``warm_steps``; the window keeps
training that trainer. The traced run turns the program's tracing on
(``spans.door()``) for its ``sdf.normal_pts`` counter, profiles
``trace_strides`` strides, and adds the device time of the hash grid's
input gradient and its backward by name (``sdf_kernel_s``) to the reading.

The check compares with the reference at the precision the configuration
states (``reference.neus.STATED``: bf16 table reads and radiance operands).
``rehearsal.json`` keys its tiny traffic by driver name, and this driver
takes the ``train`` block: on the CPU it applies that block itself.
"""

import contextlib
import json
import math
import os
import tempfile

import numpy as np
import torch

from .. import check, port, port_neus, roofline_sdf, roofline, scene, spans, trace, traffic
from ..reference import neus, ngp
from . import train as ngp_train

SCENE_OPACITY = ngp_train.SCENE_OPACITY


def rehearsal_traffic(traffic_tree):
    """The ``train`` block of rehearsal.json over ``traffic_tree``."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rehearsal.json")) as f:
        tiny = json.load(f)["traffic"]["train"]
    tree = json.loads(json.dumps(traffic_tree))
    for k, v in tiny.items():
        node = tree
        keys = k.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return tree


def leaf_shapes(model):
    enc, geo, rad = model["geometry"]["encoder"], model["geometry"], model["radiance"]
    geo_dims, rad_dims = roofline_sdf.chains(model)
    return {"table": (enc["n_levels"], 1 << enc["hashmap_size"], enc["n_feat_per_entry"]),
            "geo.0": (geo_dims[0], geo["W"]), "geo.0.wn": (geo["W"],), "geo.out": (geo["W"], geo_dims[-1]),
            "geo.out.wn": (geo_dims[-1],), "rad.0": (rad_dims[0], rad["W"]), "rad.1": (rad["W"], rad["W"]),
            "rad.out": (rad["W"], 3), "inv_s": (1,)}


def weights(model, p, seed, device):
    """The leaves by name, from the seed in two calls: the table uniform in
    +-table_range; one normal draw for the nets, shaped as the recipe
    initialises them: the geometry's first layer sqrt(2 / W) on its first
    three inputs and 0 on the rest, its last layer sqrt(pi / W) + 1e-4
    N(0, 1), the weight-norm scales 1, the radiance layers clamped at 2
    std over sqrt(fan-in) / 0.88; inv_s = -ln(init_var) / speed_factor."""
    gen = torch.Generator(device=device).manual_seed(traffic.derived_seed(seed, "weights"))
    shapes = leaf_shapes(model)
    r = float(p["table_range"])
    out = {"table": (torch.rand(shapes["table"], generator=gen, device=device) * 2 - 1) * r}
    mats = ["geo.0", "geo.out", "rad.0", "rad.1", "rad.out"]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in mats), generator=gen, device=device)
    parts = dict(zip(mats, torch.split(flat, [math.prod(shapes[k]) for k in mats])))
    w = model["geometry"]["W"]
    first = parts["geo.0"].reshape(shapes["geo.0"]) * (math.sqrt(2.0) / math.sqrt(w))
    out["geo.0"] = torch.where(torch.arange(shapes["geo.0"][0], device=device)[:, None] < 3, first, 0.0)
    out["geo.out"] = parts["geo.out"].reshape(shapes["geo.out"]) * 1e-4 + math.sqrt(math.pi) / math.sqrt(w)
    out["geo.0.wn"] = torch.ones(shapes["geo.0.wn"], device=device)
    out["geo.out.wn"] = torch.ones(shapes["geo.out.wn"], device=device)
    for k in ("rad.0", "rad.1", "rad.out"):
        out[k] = parts[k].clamp(-2.0, 2.0).reshape(shapes[k]) * (0.8796256610342398 * math.sqrt(shapes[k][0])) ** -1
    params = model.get("params", {})
    out["inv_s"] = torch.full((1,), -math.log(float(params.get("init_var", 0.05))) / float(params.get("speed_factor", 10)),
                              device=device)
    return out


def kernel_seconds(prof):
    """Device seconds of kernels K and L by name inside the profiled window."""
    events = prof.events()
    window = next((ev for ev in events if ev.name == trace.WINDOW), None)
    sums = {k: 0.0 for k in port_neus.SDF_KERNELS}
    for ev in events:
        key = port_neus.sdf_kernel_of(ev.name) if ev.device_type == torch.autograd.DeviceType.CUDA else None
        if key is None:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if window is not None:
            s, e = max(s, window.time_range.start), min(e, window.time_range.end)
        sums[key] += max(e - s, 0) / 1e6
    return sums


@contextlib.contextmanager
def profiled(sink):
    """``trace.profiled`` with ``trace.read`` composed with the device
    seconds of kernels K and L by name (``sdf_kernel_s``), which the group
    sums of ``trace.read`` put among the plain operations."""
    inner = trace.read

    def read(prof, wall):
        return dict(inner(prof, wall), sdf_kernel_s=kernel_seconds(prof))

    trace.read = read
    try:
        with trace.profiled(sink):
            yield
    finally:
        trace.read = inner


class TrainingNeus(ngp_train.Training):
    def __init__(self, ctx):
        self.ctx = ctx
        if ctx.device.type == "cpu":
            ctx.workload = dict(ctx.workload, traffic=rehearsal_traffic(ctx.workload["traffic"]))
        p = ctx.workload["traffic"]
        tree = dict(ctx.config)
        tree["progress"] = dict(tree.get("progress", {}), scan_steps=int(p["scan_steps"]), epoch=10**9)
        self.spec = neus.Spec(ctx.model)
        self.views, self.held = traffic.training_views(p["views"], ctx.seed, ctx.device)
        self.leaves0 = weights(ctx.model, p["weights"], ctx.seed, ctx.device)
        self.bits0 = scene.bitfield(self.spec.n_grid, self.spec.side).to(ctx.device)
        self.opa0 = self.bits0.to(torch.float32) * SCENE_OPACITY
        self.draw_seed = traffic.derived_seed(ctx.seed, "draws")
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_neus_")
        self.trainer = port_neus.trainer(tree, ctx.device, self.draw_seed, self.tmp.name, self.views, self.leaves0,
                                         val=[dict(self.held, img=self.held["img"].cpu())])
        progress = tree["progress"]
        self.epoch_loss = int(progress.get("epoch_loss", 100))
        self.epoch_val = int(progress.get("epoch_val", -1))
        self.epoch_save = int(progress.get("epoch_save_checkpoint", 100000))
        self.valid_counts = []
        inner = self.trainer.pipeline.record_valid_pts

        def record(n_valid, n_rays):
            self.valid_counts.append((n_valid, n_rays))
            inner(n_valid, n_rays)

        self.trainer.pipeline.record_valid_pts = record
        self.epoch = 0

    def first_steps(self):
        """The checked occupancy update, then steps 0-2 at the window's
        bucket: the update's grid, the first gradient, the leaves and the
        EMA's shadows after step 2."""
        t = self.trainer
        fg = t.bound_state["fg"]
        fg["bitfield"].copy_(self.bits0)
        fg["opafield"].copy_(self.opa0)
        every, warm = t.epoch_optim, t.epoch_optim_warmup or 0
        t.run_optimize(-(-max(warm, 1) // every) * every)
        self.prog_occ = (fg["opafield"].clone(), fg["bitfield"].clone())
        fg["opafield"].fill_(0.0)
        named = port_neus.leaves_of(t.model)
        t.pipeline.n_rays = self.first_rays = int(self.ctx.workload["traffic"]["check_rays"])
        t.train_steps(0, 1)
        beta1 = t.optimizer.param_groups[0]["betas"][0]
        self.prog_first = check.leaf_norms({k: t.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                                            / (1.0 - beta1) for k, p in named.items()})
        t.train_steps(1, 1)
        t.train_steps(2, 1)
        self.prog_change = check.leaf_norms({k: p.detach() - self.leaves0[k] for k, p in named.items()})
        decay = float(t.ema_decay)
        self.prog_ema = check.leaf_norms({k: v - (1 - decay**3) * self.leaves0[k]
                                          for k, v in port_neus.ema_of(t).items()})
        self.prog_losses = [float(x) for x in t.loss_history[:3]]
        self.epoch = 3

    def traced(self, reading):
        """Profile ``trace_strides`` strides with the program's tracing on.
        The work: each step's kept sections (the stats ring's counts, at
        most the budget) through B, E, A and D (the radiance chain), K and
        L; the occupancy updates' points through B and K; the table entries
        a point reaches from one more eager step."""
        n_strides = int(self.ctx.workload["traffic"]["trace_strides"])
        self.valid_counts.clear()
        start = len(self.trainer.loss_history)
        occupancy = []
        door = spans.door()
        stop = port_neus.watch_occupancy(self.trainer, occupancy.append)
        door.enable()
        try:
            with profiled(reading):
                for _ in range(n_strides):
                    self.stride()
            record = door.collect()
        finally:
            door.disable()
            stop()
        kept = [min(int(c), self.spec.budget) for c, _ in self.valid_counts]
        reading["units"], reading["unit"] = len(kept), "step"
        reading["normal_pts"] = float(record["counters"].get("sdf.normal_pts", 0))
        failed = ngp_train.non_finite(self.trainer.loss_history[start:])
        rows = []
        unwrap = port.wrap_hash_encode(rows.append)
        try:
            stats = self.trainer.train_step(self.epoch + 1)
        finally:
            unwrap()
        n_valid = min(int(stats["n_valid_pts"]), self.spec.budget)
        per_point = ngp_train.hash_entries(self.spec.ngp, rows) / max(n_valid, 1)
        reading["work"] = work_neus(self.spec.ngp, self.ctx.model, kept, per_point, occupancy, reading["normal_pts"])
        return len(kept), failed

    def reference(self):
        ctx = self.ctx
        pool = {k: torch.cat([torch.from_numpy(v[k]) for v in self.views]).to(ctx.device)
                for k in ("img", "mask", "rays_o", "rays_d")}
        gen = torch.Generator(device=ctx.device).manual_seed(self.draw_seed)
        opa, bits = neus.occupancy_update(self.spec, self.leaves0, self.opa0, self.bits0, gen, prec=neus.STATED)
        optim = ctx.config["optim"]
        losses, first, after, shadow = neus.train_steps(
            self.spec, self.leaves0, pool, bits, gen, self.first_rays, 3, float(optim["lr"]), float(optim["eps"]),
            float(optim.get("weight_decay", 0.0)), float(optim["ema_decay"]), neus.STATED)
        numbers = check.occupancy_numbers(*self.prog_occ, opa, bits, self.bits0)
        ctx.note("occupancy after the checked update: {} of {} voxels occupied (the scene's grid {})".format(
            int(bits.sum()), bits.numel(), int(self.bits0.sum())))
        ref_first = check.leaf_norms(first)
        numbers.update(check.train_numbers(self.prog_losses, losses, self.prog_first, ref_first, self.prog_change,
                                           check.leaf_norms({k: after[k] - self.leaves0[k] for k in after}),
                                           ctx.note))
        decay = float(optim["ema_decay"])
        ref_ema = check.leaf_norms({k: v - (1 - decay**3) * self.leaves0[k] for k, v in shadow.items()})
        numbers["ema_gap"] = ema_gap(self.prog_ema, ref_ema, ref_first)
        return numbers


def ema_gap(prog, ref, ref_first):
    """The widest gap of a leaf's EMA move (the shadow less what unchanged
    leaves would give it) against the larger of its reference and the
    median leaf's, over the leaves the training rule keeps."""
    med_g = float(np.median(list(ref_first.values())))
    med = float(np.median(list(ref.values())))
    leaves = [k for k in ref_first if ref_first[k] >= check.IDLE_LEAF * med_g]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def work_neus(spec, model, kept, entries_per_point, occupancy, normal_pts):
    """The traced window's least seconds by layer (each call's bound,
    summed), its MLP operations and the input-gradient kernels' work: the
    steps' kept sections through B, E, A and D (the radiance chain), K and
    L; the occupancy updates' points through B and K. ``normal_pts``: the
    program's count of the sections and points whose normals it took."""
    hash_s = mlp_s = flops = sdf_s = 0.0
    for pts in kept:
        entries = entries_per_point * pts
        hash_s += roofline.bound_s(*roofline.hash_fwd(model, pts, entries), roofline.F32_FLOP_S)
        hash_s += roofline.bound_s(*roofline.hash_bwd(model, pts), roofline.F32_FLOP_S)
        mlp_s += roofline.bound_s(*roofline_sdf.radiance_fwd(model, pts), roofline.BF16_FLOP_S)
        mlp_s += roofline.bound_s(*roofline_sdf.radiance_bwd(model, pts), roofline.BF16_FLOP_S)
        flops += roofline_sdf.step_flops(model, pts)
        sdf_s += roofline_sdf.bound_s(*roofline_sdf.hash_dx_bwd(model, pts, entries))
    occ_pts = 0.0
    for xyz in occupancy:
        pts = float(xyz.shape[0])
        occ_pts += pts
        entries = float(torch.unique(ngp.hash_entries(spec, xyz)).numel())
        hash_s += roofline.bound_s(*roofline.hash_fwd(model, pts, entries), roofline.F32_FLOP_S)
        sdf_s += roofline_sdf.bound_s(*roofline_sdf.hash_dx(model, pts, entries))
        flops += roofline_sdf.occupancy_flops(model, pts)
    # K over the steps' sections the counter holds besides the occupancy points
    step_pts = max(normal_pts - occ_pts, 0.0)
    sdf_s += roofline_sdf.bound_s(*roofline_sdf.hash_dx(model, step_pts, entries_per_point * step_pts))
    return {"hash_s": hash_s, "mlp_s": mlp_s, "mlp_flops": flops, "points": float(sum(kept)), "sdf_s": sdf_s}


DRIVER = TrainingNeus
