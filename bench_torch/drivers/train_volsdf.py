"""VolSDF training, as ``ArcNerfTrainer.train`` runs it: the NGP driver's
strides, cadences and window (``drivers/train.py``) on the ``volsdf``
configuration, with a fixed batch (the sphere bound has no occupancy state
and no point budget, so no dynamic batch size and no occupancy update), its
own leaves, weights, reference (``reference/volsdf.py``) and work.

Set-up builds one trainer over the benchmark's views and weights (the
recipe's init: the GeoNet's geometric init, the radiance net's lecun
normal, zero biases but the sdf's -radius_init, weight-norm scales 1,
ln_beta from init_beta) and runs three steps, one call each, at the
window's 1024 rays (``check_rays``): the first captures the step, the next
two replay it. The check follows them: the first step's samples (the
sampler's output), each step's loss, every leaf's first gradient and
change, against the reference from the same draws in the program's order.
Then strides up to ``warm_steps``; the window keeps training that
trainer. The traced run turns the program's tracing on (``spans.door()``)
for its ``volsdf.eval_pts`` and ``sdf.normal_pts`` counters, profiles
``trace_strides`` strides, and adds the device time of the dense GEMMs by
name (``gemm_device_s``) and of the operations that are neither they nor
kernels A-F nor Adam (``plain_device_s``) to the reading. On the CPU (the
rehearsal) the host operators' own time stands in for both, so that the
readers run: no measurement. On the card a window with no device operation
raises: its trace lost the device's events.
"""

import contextlib
import math
import tempfile

import torch

from .. import check, port, port_volsdf, roofline_volsdf, spans, trace, traffic
from ..reference import volsdf
from . import train as ngp_train

# a ray whose samples moved farther than this (scene units; the rays' chords
# are ~4 long) has had a decision of the sampler flip on the way: a bisection,
# or a search at a bin under sample_pdf's eps (u = 1 lands at a degenerate
# bin's far or near end as the cdf's last sum rounds above or below 1)
MOVED = 1e-4


def weights(spec, seed, device):
    """The leaves by name, from the seed in one normal draw, shaped as the
    recipe initialises them: the GeoNet's layers N(0, 2 / out) (the first
    on the points' three inputs only, the one after the skip without the
    encoding's tail), its last sqrt(pi / in) + 1e-4 N(0, 1) with the sdf's
    bias -radius_init; the radiance layers clamped at 2 std over sqrt(in) /
    0.88; the other biases 0, the weight-norm scales 1; ln_beta =
    ln(init_beta) / speed_factor."""
    gen = torch.Generator(device=device).manual_seed(traffic.derived_seed(seed, "weights"))
    shapes = spec.leaf_shapes()
    mats = [k for k, s in shapes.items() if len(s) == 2]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in mats), generator=gen, device=device)
    parts = dict(zip(mats, torch.split(flat, [math.prod(shapes[k]) for k in mats])))
    out = {}
    last = spec.D
    for k, shape in shapes.items():
        if k == "ln_beta":
            out[k] = torch.full(shape, math.log(spec.init_beta) / spec.speed, device=device)
        elif k.endswith(".wn"):
            out[k] = torch.ones(shape, device=device)
        elif k.endswith(".b"):
            out[k] = torch.zeros(shape, device=device)
            if k == "geo.{}.b".format(last):
                out[k][0] = -spec.radius_init
        elif k.startswith("rad."):
            out[k] = parts[k].clamp(-2.0, 2.0).reshape(shape) * (0.8796256610342398 * math.sqrt(shape[0])) ** -1
        else:
            i = int(k.split(".")[1])
            w = parts[k].reshape(shape)
            rows = torch.arange(shape[0], device=device)[:, None]
            if i == last:
                w = w * 1e-4 + math.sqrt(math.pi) / math.sqrt(shape[0])
            else:
                w = w * (math.sqrt(2.0) / math.sqrt(shape[1]))
                if i == 0:
                    w = torch.where(rows < 3, w, 0.0)
                elif i - 1 in spec.skips:
                    w = torch.where(rows >= shape[0] - (spec.embed - 3), 0.0, w)
            out[k] = w
    return out


def _self_s(ev):
    return getattr(ev, "self_cpu_time_total", 0.0) / 1e6


def kernel_seconds(prof, device):
    """(GEMM device seconds, device seconds outside the GEMMs, kernels A-F
    and Adam) inside the profiled window; on the CPU (``device``), the host
    operators' own seconds (matmuls; the rest)."""
    events = prof.events()
    window = next((ev for ev in events if ev.name == trace.WINDOW), None)
    gemm = plain = 0.0
    seen = False
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if window is not None:
            s, e = max(s, window.time_range.start), min(e, window.time_range.end)
        if e <= s:
            continue
        seen = True
        if port_volsdf.is_gemm(ev.name):
            gemm += (e - s) / 1e6
        elif port.kernel_of(ev.name) is None:
            plain += (e - s) / 1e6
    if device.type != "cpu":
        if not seen:
            raise RuntimeError("the profiled window holds no device operation: the trace lost the device's events")
        return gemm, plain
    ops = [ev for ev in events if ev.name.startswith("aten::")]
    gemm = sum(_self_s(ev) for ev in ops if ev.name in ("aten::mm", "aten::addmm", "aten::bmm"))
    return gemm, sum(_self_s(ev) for ev in ops) - gemm


@contextlib.contextmanager
def profiled(sink, device):
    """``trace.profiled`` with ``trace.read`` composed with the GEMMs' and
    the plain operations' device seconds (``gemm_device_s``,
    ``plain_device_s``) on ``device``."""
    inner = trace.read

    def read(prof, wall):
        gemm, plain = kernel_seconds(prof, device)
        return dict(inner(prof, wall), gemm_device_s=gemm, plain_device_s=plain)

    trace.read = read
    try:
        with trace.profiled(sink):
            yield
    finally:
        trace.read = inner


def sample_numbers(prog, ref):
    """The first step's samples (rays, n_sample + n_importance), the one
    step whose weights the program and the reference share: the share of
    rays whose samples moved farther than ``MOVED``, and the largest gap of
    the others. (Adam's first step moves each weight by about lr sign(g),
    so a gradient at rounding level whose sign differs moves the weight by
    2 lr: the later steps' samples compare weights apart by more than
    rounding, and the step numbers cover them.)"""
    gaps = (prog.float() - ref.float()).abs().amax(1)
    moved = gaps > MOVED
    rest = gaps[~moved]
    return {"sample_moved": float(moved.float().mean()), "sample_gap": float(rest.max()) if rest.numel() else 0.0}


class TrainingVolsdf(ngp_train.Training):
    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.workload["traffic"]
        tree = dict(ctx.config)
        tree["progress"] = dict(tree.get("progress", {}), scan_steps=int(p["scan_steps"]), epoch=10**9)
        self.spec = volsdf.Spec(ctx.model)
        self.views, self.held = traffic.training_views(p["views"], ctx.seed, ctx.device)
        self.leaves0 = weights(self.spec, ctx.seed, ctx.device)
        self.draw_seed = traffic.derived_seed(ctx.seed, "draws")
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_volsdf_")
        self.trainer = port_volsdf.trainer(tree, ctx.device, self.draw_seed, self.tmp.name, self.views, self.leaves0,
                                           self.spec, val=[dict(self.held, img=self.held["img"].cpu())])
        progress = tree["progress"]
        self.epoch_loss = int(progress.get("epoch_loss", 100))
        self.epoch_val = int(progress.get("epoch_val", -1))
        self.epoch_save = int(progress.get("epoch_save_checkpoint", 100000))
        self.epoch = 0

    def first_steps(self):
        """Steps 0-2, one call each, at the window's batch: step 0's samples
        (its eager call: on the card the warm-up before the capture), the
        gradient Adam got in step 0 and the leaves after step 2."""
        t = self.trainer
        named = port_volsdf.leaves_of(t.model, self.spec)
        t.pipeline.n_rays = self.first_rays = int(self.ctx.workload["traffic"]["check_rays"])
        seen = []
        stop = port_volsdf.watch_samples(t, seen.append)
        try:
            t.train_steps(0, 1)
        finally:
            stop()
        self.prog_samples = seen[0].detach().clone()
        seen.clear()
        beta1 = t.optimizer.param_groups[0]["betas"][0]
        # a leaf with no Adam state got no gradient
        self.prog_first = check.leaf_norms({k: t.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                                            for k, p in named.items()})
        t.train_steps(1, 1)
        t.train_steps(2, 1)
        self.prog_change = check.leaf_norms({k: p.detach() - self.leaves0[k] for k, p in named.items()})
        self.prog_losses = [float(x) for x in t.loss_history[:3]]
        self.epoch = 3

    def setup(self):
        self.first_steps()
        while self.epoch < int(self.ctx.workload["traffic"]["warm_steps"]):
            self.stride()
        self.ctx.sync()
        held = self.trainer.render_image(self.held)
        mse = float(((held["rgb"].reshape(-1, 3).float() - self.held["img"].float()) ** 2).mean())
        self.ctx.note("held-out view after {} steps: PSNR {:.3f} dB; {} rays a step".format(
            self.epoch, -10.0 * math.log10(max(mse, 1e-12)), self.trainer.pipeline.n_rays))

    def traced(self, reading):
        """Profile ``trace_strides`` strides with the program's tracing on.
        The work: the GEMMs of the points the program counts."""
        n_strides = int(self.ctx.workload["traffic"]["trace_strides"])
        start, epoch0 = len(self.trainer.loss_history), self.epoch
        door = spans.door()
        door.enable()
        try:
            with profiled(reading, self.ctx.device):
                for _ in range(n_strides):
                    self.stride()
            record = door.collect()
        finally:
            door.disable()
        steps = self.epoch - epoch0
        reading["units"], reading["unit"] = steps, "step"
        counters = record["counters"]
        reading["work"] = roofline_volsdf.work(self.ctx.model, float(counters.get("volsdf.eval_pts", 0)),
                                               float(counters.get("sdf.normal_pts", 0)))
        return steps, ngp_train.non_finite(self.trainer.loss_history[start:])

    def reference(self):
        ctx = self.ctx
        pool = {k: torch.cat([torch.from_numpy(v[k]) for v in self.views]).to(ctx.device)
                for k in ("img", "rays_o", "rays_d")}
        gen = torch.Generator(device=ctx.device).manual_seed(self.draw_seed)
        optim = ctx.config["optim"]
        sched = optim.get("lr_scheduler", {})
        losses, first, after, zs = volsdf.train_steps(
            self.spec, self.leaves0, pool, gen, self.first_rays, 3, float(optim["lr"]), float(optim.get("eps", 1e-8)),
            float(sched.get("lr_gamma", 0.1)), float(sched.get("lr_steps", [500000])[0]))
        numbers = sample_numbers(self.prog_samples, zs[0])
        numbers.update(check.train_numbers(self.prog_losses, losses, self.prog_first, check.leaf_norms(first),
                                           self.prog_change,
                                           check.leaf_norms({k: after[k] - self.leaves0[k] for k in after}),
                                           ctx.note))
        return numbers


DRIVER = TrainingVolsdf
