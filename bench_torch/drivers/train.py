"""Training, as ``ArcNerfTrainer.train`` runs it: strides of up to
``progress.scan_steps`` steps (replays of the step captured for each batch
bucket on the card; eager steps where scan_steps is 1), cut where
``train()`` cuts them, with the dynamic batch size and the occupancy update
between strides, the loss read and logged every ``epoch_loss`` steps and a
held-out view validated every ``epoch_val``. ``train()``'s checkpoints are
left out (no disk writes in the window).

Set-up builds one trainer over the benchmark's views and weights. Its
occupancy state is first given the benchmark's grid (the scene's voxels at
opacity 1, the others at 0), and the trainer runs its occupancy update as
it runs after the warm-up (sampled voxels, from its own generator); the
opacity field then returns to the recipe's initial 0, so that from the
first update of training on the grid is the program's own. Then three
steps, one call each, at the batch bucket of the window (``check_rays``)
on the updated grid: the first captures that bucket's step, the next two
replay it. The correctness check follows the update and those steps. Then
strides up to ``warm_steps``. The window keeps training that same trainer:
``train_rays_per_s`` is every ray of every step completed in it over its
wall time, which ends in a synchronize. The traced run profiles
``trace_strides`` strides instead.
"""

import gc
import math
import tempfile

import numpy as np
import torch

from .. import check, port, roofline, scene, traffic
from ..reference import ngp

# the opacity the benchmark's grid gives the scene's voxels before the
# checked occupancy update: far above the threshold, so the update keeps
# them, and enough to hold the mean opacity above the threshold, so the
# voxels it samples elsewhere fall below it
SCENE_OPACITY = 1.0


class Training:
    def __init__(self, ctx):
        self.ctx = ctx
        p = ctx.workload["traffic"]
        tree = dict(ctx.config)
        tree["progress"] = dict(tree.get("progress", {}), scan_steps=int(p["scan_steps"]), epoch=10**9)
        self.views, self.held = traffic.training_views(p["views"], ctx.seed, ctx.device)
        self.leaves0 = traffic.weights(ctx.model, p["weights"], ctx.seed, ctx.device)
        self.bits0 = scene.bitfield(ctx.spec.n_grid, ctx.spec.side).to(ctx.device)
        self.opa0 = self.bits0.to(torch.float32) * SCENE_OPACITY
        self.draw_seed = traffic.derived_seed(ctx.seed, "draws")
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_train_")
        self.trainer = port.trainer(tree, ctx.device, self.draw_seed, self.tmp.name, self.views, self.leaves0,
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

    # ------------------------------------------------------------ set-up
    def first_steps(self):
        """The checked occupancy update, then steps 0-2, one call each, at
        the window's bucket: the update's grid, the gradient Adam got in
        step 0 and the leaves after step 2."""
        t = self.trainer
        fg = t.bound_state["fg"]
        fg["bitfield"].copy_(self.bits0)
        fg["opafield"].copy_(self.opa0)
        every, warm = t.epoch_optim, t.epoch_optim_warmup or 0
        t.run_optimize(-(-max(warm, 1) // every) * every)  # the first update after the warm-up
        self.prog_occ = (fg["opafield"].clone(), fg["bitfield"].clone())
        fg["opafield"].fill_(0.0)  # the recipe's initial field: training's first update rebuilds the grid
        named = port.leaves_of(t.model)
        t.pipeline.n_rays = self.first_rays = int(self.ctx.workload["traffic"]["check_rays"])
        t.train_steps(0, 1)
        beta1 = t.optimizer.param_groups[0]["betas"][0]
        # a leaf with no Adam state got no gradient
        self.prog_first = check.leaf_norms({k: t.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                                            / (1.0 - beta1) for k, p in named.items()})
        t.train_steps(1, 1)
        t.train_steps(2, 1)
        self.prog_change = check.leaf_norms({k: p.detach() - self.leaves0[k] for k, p in named.items()})
        self.prog_losses = [float(x) for x in t.loss_history[:3]]
        self.epoch = 3

    def stride(self):
        """One stride as ``train()`` runs it, and the loss log and the
        validation that end on it; returns its steps and rays."""
        t = self.trainer
        if t.log_max_allowance:
            t.pipeline.update_dynamic_bs(self.epoch, t.log_max_allowance)
        cadences = (self.epoch_loss, self.epoch_val, self.epoch_save,
                    t.pipeline.dynamic_update_epoch if t.log_max_allowance else None, t.epoch_optim)
        n = t._stride_for(self.epoch, cadences)
        stats = t.train_steps(self.epoch, n)
        self.epoch += n
        if self.epoch % self.epoch_loss == 0:
            t._warn_budget_overflow(stats)
            t.logger.add_log("epoch {:6d} | loss {:.5f} | psnr {:.2f} | rays {}".format(
                self.epoch, float(stats["loss"]), float(stats.get("psnr", 0.0)), stats["n_rays"]))
        if self.epoch_val > 0 and self.epoch % self.epoch_val == 0:
            t.valid_epoch(self.epoch)
        return n, n * int(stats["n_rays"])

    def setup(self):
        self.first_steps()
        while self.epoch < int(self.ctx.workload["traffic"]["warm_steps"]):
            self.stride()
        self.ctx.sync()
        held = self.trainer.render_image(self.held, bkg_color=np.ones(3, dtype=np.float32))
        mse = float(((held["rgb"].reshape(-1, 3).float() - self.held["img"].float()) ** 2).mean())
        self.ctx.note("held-out view after {} steps: PSNR {:.3f} dB; bucket {} rays".format(
            self.epoch, -10.0 * math.log10(max(mse, 1e-12)), self.trainer.pipeline.n_rays))

    # ------------------------------------------------------------ window
    def window(self, seconds):
        steps = rays = 0
        start = len(self.trainer.loss_history)
        self.ctx.note("window: from epoch {}, bucket {} rays (the checked steps ran at {})".format(
            self.epoch, self.trainer.pipeline.n_rays, self.first_rays))
        t0 = self.ctx.clock()
        while True:
            n, r = self.stride()
            steps, rays = steps + n, rays + r
            if self.ctx.clock() - t0 >= seconds:
                break
        self.ctx.sync()
        wall = self.ctx.clock() - t0
        self.ctx.note("window: {} steps to epoch {}, bucket {} rays at its end".format(
            steps, self.epoch, self.trainer.pipeline.n_rays))
        return {"train_rays_per_s": rays / wall}, steps, non_finite(self.trainer.loss_history[start:])

    def traced(self, reading):
        """Profile ``trace_strides`` strides. The work: each step's kept
        samples (the stats ring's counts, at most the point budget), the
        points of the occupancy updates (eager: the encoding's entry sees
        them), and the table entries a step's points reach, per point, from
        one more eager step (replays call no Python to watch)."""
        n_strides = int(self.ctx.workload["traffic"]["trace_strides"])
        self.valid_counts.clear()
        start = len(self.trainer.loss_history)
        occupancy = []

        def watch(xyz):
            if not torch.is_grad_enabled():  # the occupancy update; a step's forward records gradients
                occupancy.append(xyz)

        unwrap = port.wrap_hash_encode(watch)
        try:
            with self.ctx.profiled(reading):
                for _ in range(n_strides):
                    self.stride()
        finally:
            unwrap()
        kept = [min(int(c), self.ctx.spec.budget) for c, _ in self.valid_counts]
        reading["units"], reading["unit"] = len(kept), "step"
        failed = non_finite(self.trainer.loss_history[start:])
        rows = []
        unwrap = port.wrap_hash_encode(rows.append)
        try:
            stats = self.trainer.train_step(self.epoch + 1)  # off the occupancy cadence
        finally:
            unwrap()
        n_valid = min(int(stats["n_valid_pts"]), self.ctx.spec.budget)
        per_point = hash_entries(self.ctx.spec, rows) / max(n_valid, 1)
        reading["work"] = work_train(self.ctx.spec, self.ctx.model, kept, per_point, occupancy)
        return len(kept), failed

    # ------------------------------------------------------------- check
    def free(self):
        self.trainer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        self.tmp.cleanup()

    def reference(self):
        ctx = self.ctx
        pool = {k: torch.cat([torch.from_numpy(v[k]) for v in self.views]).to(ctx.device)
                for k in ("img", "mask", "rays_o", "rays_d")}
        gen = torch.Generator(device=ctx.device).manual_seed(self.draw_seed)
        opa, bits = ngp.occupancy_update(ctx.spec, self.leaves0, self.opa0, self.bits0, gen)
        optim = ctx.config["optim"]
        losses, first, after = ngp.train_steps(ctx.spec, self.leaves0, pool, bits, gen, self.first_rays, 3,
                                               float(optim["lr"]), float(optim["eps"]), ngp.F32)
        numbers = check.occupancy_numbers(*self.prog_occ, opa, bits, self.bits0)
        ctx.note("occupancy after the checked update: {} of {} voxels occupied (the scene's grid {})".format(
            int(bits.sum()), bits.numel(), int(self.bits0.sum())))
        numbers.update(check.train_numbers(self.prog_losses, losses, self.prog_first, check.leaf_norms(first),
                                           self.prog_change,
                                           check.leaf_norms({k: after[k] - self.leaves0[k] for k in after}),
                                           ctx.note))
        return numbers


def non_finite(losses):
    """The steps whose loss is not finite."""
    return int((~torch.isfinite(torch.stack(losses).float())).sum())


def hash_entries(spec, rows):
    """The table entries the corners of each call's points reach, summed
    over calls (each call reads its own)."""
    return sum(int(torch.unique(ngp.hash_entries(spec, xyz)).numel()) for xyz in rows)


def work_train(spec, model, kept, entries_per_point, occupancy):
    """The traced window's least seconds by layer (each call's bound,
    summed) and its MLP operations: the steps' kept samples through B, E,
    A (the training build, both chains) and D; the occupancy updates'
    points through B and A (the geometry chain)."""
    hash_s = mlp_s = flops = 0.0
    for pts in kept:
        hash_s += roofline.bound_s(*roofline.hash_fwd(model, pts, entries_per_point * pts), roofline.F32_FLOP_S)
        hash_s += roofline.bound_s(*roofline.hash_bwd(model, pts), roofline.F32_FLOP_S)
        mlp_s += roofline.bound_s(*roofline.mlp_fwd(model, pts, save_pre=True), roofline.BF16_FLOP_S)
        mlp_s += roofline.bound_s(*roofline.mlp_bwd(model, pts), roofline.BF16_FLOP_S)
        flops += 3.0 * pts * roofline.mlp_flops_per_sample(model)
    for xyz in occupancy:
        pts = float(xyz.shape[0])
        entries = float(torch.unique(ngp.hash_entries(spec, xyz)).numel())
        hash_s += roofline.bound_s(*roofline.hash_fwd(model, pts, entries), roofline.F32_FLOP_S)
        mlp_s += roofline.bound_s(*roofline.mlp_fwd(model, pts, chains=(0,)), roofline.BF16_FLOP_S)
        flops += pts * roofline.mlp_flops_per_sample(model, chains=(0,))
    return {"hash_s": hash_s, "mlp_s": mlp_s, "mlp_flops": flops, "points": float(sum(kept))}


DRIVER = Training
