"""ArcNerfTrainer: the NGP training loop on one device.

Counterpart of ``arcnerf_tpu/trainer/trainer.py`` (init and data,
``init_state``, ``_train_step_impl``, ``_optimize_impl``, ``run_optimize``,
``_stride_for``, ``train_steps``, ``train``, ``valid_epoch``,
``eval_params``). Where the JAX trainer jits a pure step over a state
pytree and shards the batch over a device mesh, this one runs on one device
with ``nn.Module`` parameters, a fused ``torch.optim.Adam`` whose rate is a
device tensor, and an explicit occupancy state dict:

- all training rays live on the device (``Pipeline``) and each step draws
  its batch there from a seeded ``torch.Generator``, which also gives the
  sample jitter, sigma noise and occupancy-update draws;
- one optimizer step per epoch; at epochs e > 0 with e % epoch_optim == 0
  the occupancy update runs before the step (every voxel centre while
  e < epoch_optim_warmup, sampled voxels after), and writes into the
  occupancy tensors in place;
- with progress.scan_steps > 1, ``train`` runs strides of steps that end on
  every host event (logging, validation, checkpoints, the dynamic batch
  size, the occupancy update), each through ``train_steps``: on the card a
  replay of the step captured as a CUDA graph for the batch bucket
  (``step_graph.StepGraph``), on the CPU the same static-buffer step; with
  scan_steps 1 every step runs eagerly (``train_step``);
- the dynamic batch size reads the measured valid-sample counts on the
  host only at its update cadence; nothing else syncs per step;
- while tracing is on (``utils.profiler``) a stride or an eager step is
  one ``train.stride`` span, the occupancy update ``train.occupancy``, and
  the steps' valid samples past the point budget (``compact.dropped``)
  and an SDF's kept sections (``sdf.normal_pts``) are counted outside the
  captured step;
- validation renders through the serving path (``RenderEngine``), whose
  render tiers the trainer also hands on (``set_render_cap``,
  ``render_image_fast``, ``render_image_interactive``,
  ``render_image_windowed``), each with ``eval_params``.

Options this slice does not port raise NotImplementedError naming their
ROADMAP item.
"""

import contextlib
import math
import os
import time

import numpy as np
import torch

from ..datasets import get_dataset
from ..losses import build_loss
from ..metrics import AverageDictCounter, psnr, ssim
from ..models import build_model
from ..models.base_modules.encoding import hash_variant_from_cfgs
from ..render.engine import RenderEngine
from ..utils import profiler
from ..utils.cfgs import dump_configs, get_value_from_cfgs_field, valid_key_in_cfgs
from ..utils.logger import Logger
from ..utils.model_io import load_record, save_model
from .ema import ema_debiased, ema_init, ema_update
from .optimizer import build_optimizer
from .pipeline import Pipeline
from .step_graph import StepGraph

# (config path, value that is not ported, ROADMAP item) checked at init
_UNPORTED = (
    (("dist", "model_parallel"), lambda v: int(v) > 1, "item 7"),
    (("optim", "clip_warmup"), lambda v: int(v) > 0, "item 4"),
    (("dataset", "train", "augmentation"), lambda v: v is not None, "item 4"),
    (("viewer",), lambda v: bool(v), "item 6"),
)


def _lookup(cfgs, path):
    node = cfgs
    for key in path:
        node = get_value_from_cfgs_field(node, key, None)
    return node


class ArcNerfTrainer:

    def __init__(self, cfgs):
        self.cfgs = cfgs
        for path, bad, item in _UNPORTED:
            value = _lookup(cfgs, path)
            if value is not None and bad(value):
                raise NotImplementedError("{} = {} is not ported yet (ROADMAP Queue 1, {})".format(
                    ".".join(path), value, item))
        self.device = torch.device(get_value_from_cfgs_field(cfgs, "device", "cuda:0"))

        name = get_value_from_cfgs_field(cfgs, "name", "expr")
        expr_dir = get_value_from_cfgs_field(cfgs.dir, "expr_dir", None) if hasattr(cfgs, "dir") else None
        self.expr_dir = expr_dir or os.path.join("experiments", name)
        self.ckpt_dir = os.path.join(self.expr_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        dump_configs(cfgs, os.path.join(self.expr_dir, "cfgs.yaml"))
        self.logger = Logger(os.path.join(self.expr_dir, "train.log"))

        seed = get_value_from_cfgs_field(cfgs.dist, "random_seed", None) if hasattr(cfgs, "dist") else None
        self.seed = int(seed) if seed is not None else 0
        # every draw of training (ray picks, background colours, jitter,
        # noise, voxel picks) comes from this generator on the device
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

        self.model = build_model(cfgs, self.logger, generator=torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.add_log("Model params: {:.2f}M on {}".format(n_params / 1e6, self.device))
        hv = hash_variant_from_cfgs(cfgs.model)
        self._ckpt_meta = {"hash_variant": hv} if hv is not None else {}
        self.loss_factory = build_loss(cfgs, self.logger)

        self.data = self.prepare_data()
        self.total_epoch = int(get_value_from_cfgs_field(cfgs.progress, "epoch", 100000))

        self.step_graphs = {}  # (n_rays, fed keys) -> StepGraph
        self.scan_steps = max(1, int(get_value_from_cfgs_field(cfgs.progress, "scan_steps", 1)))
        self.optimizer, self.lr_schedule = build_optimizer(cfgs.optim, self.model.parameters(), self.device)
        # the updates applied, on the device: the rate of an update is
        # lr_schedule(this count), and the step itself increments it
        self._updates = torch.zeros((), device=self.device)
        self.ema_decay = get_value_from_cfgs_field(cfgs.optim, "ema_decay", None)
        self.ema = ema_init(self.model.named_parameters()) if self.ema_decay else None
        self.bound_state = self.model.init_bound_state(self.device)
        self.step = 0  # optimizer updates applied
        self.start_epoch = 0

        fg_bound = self.model.fg_model.get_obj_bound()
        self.epoch_optim = fg_bound.get_optim_cfgs("epoch_optim")
        self.epoch_optim_warmup = fg_bound.get_optim_cfgs("epoch_optim_warmup")
        self.n_coarse = self.model.fg_model.get_ray_cfgs("n_sample")
        budget = self.model.fg_model.get_render_cfgs("max_allowance")
        self.log_max_allowance = int(math.log2(budget)) if budget and budget > 0 else None
        self.chunk_pts = int(get_value_from_cfgs_field(cfgs.model, "chunk_pts", 1 << 20))

        resume = get_value_from_cfgs_field(cfgs, "resume", None)
        if resume and resume != "None" and os.path.exists(str(resume)):
            start_cfg = int(get_value_from_cfgs_field(cfgs.progress, "start_epoch", -1))
            self.resume_from(str(resume), restore_optimizer=start_cfg < 0)

        self.engine = RenderEngine(self.model, cfgs, self.bound_state, self.device)
        self.loss_history = []  # per-step losses, device tensors (read at log time)
        self._warned_budget_overflow = False
        self.logger.add_log("Trainer ready: {} steps, {} rays per batch to start".format(
            self.total_epoch, self.pipeline.n_rays))

    @property
    def step(self):
        """Optimizer updates applied (the host's count)."""
        return self._step

    @step.setter
    def step(self, value):
        self._step = int(value)
        self._updates.fill_(self._step)

    @property
    def bound_state(self):
        """The occupancy state. Setting a new one drops the captured steps,
        which read the old tensors; the occupancy update writes in place."""
        return self._bound_state

    @bound_state.setter
    def bound_state(self, value):
        self._bound_state = value
        self.step_graphs.clear()

    # ----------------------------------------------------------------- data
    def prepare_data(self):
        data_dir = get_value_from_cfgs_field(self.cfgs.dir, "data_dir", "data") if hasattr(self.cfgs, "dir") else "data"
        train_set = get_dataset(self.cfgs.dataset, data_dir, "train", None, self.logger)
        sched = get_value_from_cfgs_field(self.cfgs.dataset.train, "scheduler", None)
        self.pipeline = Pipeline(sched, int(get_value_from_cfgs_field(self.cfgs, "n_rays", 4096)), self.device)
        self.pipeline.process_train_data([train_set[i] for i in range(len(train_set))])
        self.logger.add_log("Train pool: {} rays on {}".format(self.pipeline.n_total_rays, self.device))
        data = {"train": train_set}
        for mode in ("val", "eval"):
            if valid_key_in_cfgs(self.cfgs.dataset, mode):
                data[mode] = get_dataset(self.cfgs.dataset, data_dir, mode, None, self.logger)
        return data

    # ---------------------------------------------------------- checkpoints
    def adam_state(self):
        """The Adam state by parameter name."""
        state = self.optimizer.state
        return {name: dict(state[p]) for name, p in self.model.named_parameters() if p in state}

    def load_adam_state(self, by_name):
        """Set the Adam state by parameter name (a checkpoint's "adam", or
        ``utils.model_io.adam_state_from_jax``), on the parameters'
        device as the fused, capturable Adam keeps it. New state tensors
        drop the captured steps."""
        self.step_graphs.clear()
        for name, p in self.model.named_parameters():
            if name in by_name:
                s = by_name[name]
                self.optimizer.state[p] = {"step": s["step"].detach().to(p.device, torch.float32).clone(),
                                           "exp_avg": s["exp_avg"].to(p.device, torch.float32).clone(),
                                           "exp_avg_sq": s["exp_avg_sq"].to(p.device, torch.float32).clone()}

    def save(self, names, epoch):
        for name in names:
            save_model(os.path.join(self.ckpt_dir, name + ".pt"), self.model.state_dict(), self.bound_state,
                       meta=self._ckpt_meta, step=epoch, adam=self.adam_state(), ema=self.ema)
        self.logger.add_log("Saved checkpoint at step {} -> {}".format(epoch, names))

    def resume_from(self, path, restore_optimizer=True):
        """Load a port checkpoint; with ``restore_optimizer`` also the Adam
        state, the EMA and the step, and training continues from it."""
        record = load_record(path, self._ckpt_meta or None, self.device)
        self.model.load_state_dict(record["state_dict"])
        if record["bound_state"]:
            self.bound_state = {k: dict(v) for k, v in record["bound_state"].items()}
        if restore_optimizer:
            self.load_adam_state(record.get("adam", {}))
            if self.ema is not None and record.get("ema"):
                self.ema = {k: v.to(self.device) for k, v in record["ema"].items()}
                self.step_graphs.clear()
            self.step = self.start_epoch = int(record["step"])
        self.logger.add_log("Loaded checkpoint {} (step {})".format(path, record["step"]))

    # ------------------------------------------------------------ occupancy
    @torch.no_grad()
    def _fg_opacity(self, dt, pts):
        """Estimated opacity at (N, 3) points, in chunks of chunk_pts."""
        return torch.cat([self.model.get_est_opacity(dt, pts[s:s + self.chunk_pts])
                          for s in range(0, pts.shape[0], self.chunk_pts)])

    @torch.no_grad()
    def run_optimize(self, cur_epoch):
        """The occupancy update at epochs e > 0 with e % epoch_optim == 0,
        written into the occupancy tensors that the captured steps read."""
        if not self.epoch_optim or cur_epoch <= 0 or cur_epoch % self.epoch_optim != 0:
            return
        if not self.bound_state.get("fg"):
            return
        warmup = self.epoch_optim_warmup is not None and cur_epoch < self.epoch_optim_warmup
        fg_bound = self.model.fg_model.get_obj_bound()
        fg = self.bound_state["fg"]
        with profiler.span("train.occupancy", epoch=cur_epoch):
            new = fg_bound.optimize(fg, 0 if warmup else 10**9, self.n_coarse, self._fg_opacity,
                                    generator=self.generator)
            for k, v in new.items():
                fg[k].copy_(v)

    # ------------------------------------------------------------ train step
    def update(self, feed):
        """Forward, loss, backward, Adam at the scheduled rate and the EMA on
        one batch: the device work of a step, with no host value in it
        (``StepGraph`` captures it). Returns its stats, device tensors."""
        # the epoch reaches the model as the device count of updates (NeuS's annealed slope)
        out = self.model(dict(feed, cur_epoch=self._updates), inference_only=False, bound_state=self.bound_state,
                         generator=self.generator)
        loss_dict = self.loss_factory(feed, out)
        self.optimizer.zero_grad(set_to_none=True)
        loss_dict["sum"].backward()
        lr = self.lr_schedule(self._updates)
        for group in self.optimizer.param_groups:
            group["lr"].copy_(lr)
        self.optimizer.step()
        self._updates.add_(1)
        if self.ema is not None:
            ema_update(self.ema, self.model.named_parameters(), self.ema_decay)

        stats = {"loss": loss_dict["sum"].detach()}
        for k in loss_dict["names"]:
            stats["loss/" + k] = loss_dict[k].detach()
        for k in ("rgb_fine", "rgb", "rgb_coarse"):
            if out.get(k) is not None:
                stats["psnr"] = psnr(out[k].detach(), feed["img"])
                break
        if "n_valid_pts" in out:
            stats["n_valid_pts"] = out["n_valid_pts"]
        return stats

    def train_step(self, epoch, feed=None):
        """One eager optimizer step at ``epoch`` (the occupancy update first,
        on its cadence). ``feed`` (dict of (1, n_rays, ...) tensors) replaces
        the drawn batch. Returns stats of device tensors."""
        with profiler.span("train.stride", epoch=epoch, steps=1):
            self.run_optimize(epoch)
            if feed is None:
                feed = self.pipeline.sample(self.generator)
            n_rays = feed["rays_o"].shape[1]
            stats = self.update(feed)
            self._step += 1
            if "n_valid_pts" in stats and self.log_max_allowance:
                self.pipeline.record_valid_pts(stats["n_valid_pts"], n_rays)
                self._count_steps(stats["n_valid_pts"])
            self._count_fused_sampling(1)
        stats["n_rays"] = n_rays
        return stats

    def _count_steps(self, n_valid):
        """The steps' compaction counters (``n_valid``: their valid-sample
        counts) and, for an SDF model, ``sdf.normal_pts``: the sections
        each step keeps, whose normals it takes."""
        budget = 1 << self.log_max_allowance
        profiler.count_compact(n_valid, budget)
        if profiler.active() and self.model.fg_model.sigma_reverse():
            profiler.count("sdf.normal_pts", n_valid.clamp_max(budget).sum())

    def _count_fused_sampling(self, steps):
        """Count ``steps`` training steps under ``sample.fused`` where the
        step samples through the fused sampler (here, outside the captured
        step, which a replay does not run in Python)."""
        if profiler.active() and self.model.fg_model.fuses_sampling(self.bound_state.get("fg")):
            profiler.count("sample.fused", steps)

    def _stride_for(self, epoch, cadences):
        """How many steps can run as one stride without crossing a host-side
        event (logging, validation, saving, ...): events land exactly on
        stride ends."""
        stride = min(self.scan_steps, self.total_epoch - epoch)
        for c in cadences:
            if c is not None and c > 0:
                stride = min(stride, c - (epoch % c))
        return max(1, stride)

    def _step_graph(self, n_rays, stride, feed=None):
        """The bucket's StepGraph (fed form when ``feed`` is a batch), made
        when missing or when its ring is shorter than ``stride``."""
        key = (n_rays, None if feed is None else tuple(sorted(feed)))
        graph = self.step_graphs.get(key)
        if graph is None or graph.capacity < stride:
            graph = self.step_graphs[key] = StepGraph(self, n_rays, max(self.scan_steps, stride), feed)
        return graph

    def train_steps(self, epoch, stride, feeds=None):
        """Run ``stride`` consecutive optimizer steps from ``epoch`` (the
        occupancy update first, on its cadence); ``feeds``, one batch a
        step, replaces the drawn batches. With scan_steps 1 and stride 1 the
        step is eager; else the steps run through the bucket's static-buffer
        step: replays of its CUDA graph on the card. Appends each step's
        loss to ``loss_history``; returns the stats of the last step."""
        if stride <= 1 and self.scan_steps <= 1:
            stats = self.train_step(epoch, None if feeds is None else feeds[0])
            self.loss_history.append(stats["loss"])
            return stats
        with profiler.span("train.stride", epoch=epoch, steps=stride):
            self.run_optimize(epoch)
            if feeds is None:
                n_rays = min(self.pipeline.n_rays, self.pipeline.n_total_rays)
            else:
                n_rays = feeds[0]["rays_o"].shape[1]
            seq = self._step_graph(n_rays, stride, None if feeds is None else feeds[0]).run(stride, feeds)
            self._step += stride
            self.loss_history.extend(seq["loss"].unbind())
            if "n_valid_pts" in seq and self.log_max_allowance:
                for count in seq["n_valid_pts"].unbind():
                    self.pipeline.record_valid_pts(count, n_rays)
                self._count_steps(seq["n_valid_pts"])
            self._count_fused_sampling(stride)
        stats = {k: v[-1] for k, v in seq.items()}
        stats["n_rays"] = n_rays
        return stats

    # ------------------------------------------------------------ rendering
    def eval_params(self):
        """Parameters to render with: the debiased EMA shadows when
        optim.ema_decay is set, else the live ones (by name)."""
        if self.ema is not None:
            return ema_debiased(self.ema, self.step, self.ema_decay)
        return dict(self.model.named_parameters())

    def eval_bkg_color(self, mode="val"):
        """Background to composite at render time: only when training
        composites one onto the gt (scheduler.bkg_color), then the split's
        augmentation.blend_bkg_color, or white under white_bkg."""
        if self.pipeline.bkg_color_mode is None:
            return None
        ds_cfgs = get_value_from_cfgs_field(self.cfgs.dataset, mode, None)
        if ds_cfgs is None:
            return None
        blend = get_value_from_cfgs_field(get_value_from_cfgs_field(ds_cfgs, "augmentation", None),
                                          "blend_bkg_color", None)
        if blend is not None:
            return np.asarray(blend, dtype=np.float32)
        if get_value_from_cfgs_field(ds_cfgs, "white_bkg", False):
            return np.ones(3, dtype=np.float32)
        return None

    def _val_chunk_rays(self):
        """Rays per render chunk for validation. Without a per-ray cap
        (obj_bound.eval_max_pts_per_ray) the engine's chunk would let a
        chunk's valid samples exceed the point budget, and compaction would
        drop the tail rays' samples; chunks of budget / n_sample rays can
        never clip."""
        if self.model.fg_model.get_obj_bound().get_optim_cfgs().get("eval_max_pts_per_ray"):
            return None
        if not self.log_max_allowance:
            return None
        return max(1, (1 << self.log_max_allowance) // int(self.n_coarse))

    @contextlib.contextmanager
    def _eval_weights(self):
        """The model holds ``eval_params`` (and the engine the live occupancy
        state) inside the block; the live parameters come back after it."""
        self.engine.bound_state = self.bound_state
        if self.ema is None:
            yield
            return
        with torch.no_grad():
            live = {k: v.detach().clone() for k, v in self.model.named_parameters()}
            params = dict(self.model.named_parameters())
            for k, v in self.eval_params().items():
                params[k].copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for k, v in live.items():
                    params[k].copy_(v)

    def render_image(self, sample, bkg_color=None):
        """Render a dataset sample through the serving path with
        ``eval_params`` and the live occupancy state, in clip-free chunks."""
        with self._eval_weights():
            return self.engine.render_image(sample, self._val_chunk_rays(), bkg_color=bkg_color)

    # the render tiers, delegated to the RenderEngine with eval_params
    def set_render_cap(self, cap, n_sample=None, window=False):
        return self.engine.set_render_cap(cap, n_sample=n_sample, window=window)

    def render_image_fast(self, sample, **kwargs):
        with self._eval_weights():
            return self.engine.render_image_fast(sample, **kwargs)

    def render_image_interactive(self, sample, **kwargs):
        with self._eval_weights():
            return self.engine.render_image_interactive(sample, **kwargs)

    def render_image_windowed(self, sample, **kwargs):
        with self._eval_weights():
            return self.engine.render_image_windowed(sample, **kwargs)

    def valid_epoch(self, epoch, mode="val"):
        """Render the split's first progress.max_samples_val images; log and
        return the mean PSNR/SSIM."""
        dataset = self.data[mode]
        counter = AverageDictCounter()
        max_samples = int(get_value_from_cfgs_field(self.cfgs.progress, "max_samples_val", 1))
        bkg_color = self.eval_bkg_color(mode)
        with profiler.span("train.validate", epoch=epoch):
            for i in range(min(len(dataset), max_samples)):
                sample = dataset[i]
                imgs = {k: profiler.host_read(v.float(), "train.validate", torch.Tensor.cpu)
                        for k, v in self.render_image(sample, bkg_color=bkg_color).items()}
                gt = torch.as_tensor(sample["img"]).reshape(imgs["rgb"].shape)
                counter({"psnr": float(psnr(imgs["rgb"], gt)), "ssim": float(ssim(imgs["rgb"], gt))})
        summary = counter.get_avg_summary()
        self.logger.add_log("[{}] epoch {} | {}".format(mode, epoch, counter.get_metric_info()))
        return summary

    def _warn_budget_overflow(self, stats):
        """Once per run, at the log cadence (a host read there is free): the
        compaction keeps only the first 2^log_max_allowance valid samples,
        and the dynamic batch size rounds up to its bucket, so the tail
        rays of a batch can lose their samples (as in the JAX trainer)."""
        if self._warned_budget_overflow or not self.log_max_allowance or "n_valid_pts" not in stats:
            return
        n_valid = profiler.host_read(stats["n_valid_pts"], "train.budget_check")
        budget = 1 << self.log_max_allowance
        if n_valid > budget:
            self.logger.add_log("valid pts {} > compaction budget 2^{}={}; over-budget points are dropped - raise "
                                "model.obj_bound.log_max_allowance or reduce rays/samples".format(
                                    n_valid, self.log_max_allowance, budget), level="warning")
            self._warned_budget_overflow = True

    # ------------------------------------------------------------- main loop
    def train(self):
        self.logger.add_log("Start training: {} epochs (1 step/epoch, strides of up to {})".format(
            self.total_epoch, self.scan_steps))
        progress = self.cfgs.progress
        epoch_loss = int(get_value_from_cfgs_field(progress, "epoch_loss", 100))
        epoch_val = int(get_value_from_cfgs_field(progress, "epoch_val", -1))
        epoch_save = int(get_value_from_cfgs_field(progress, "epoch_save_checkpoint", 100000))
        save_time = float(get_value_from_cfgs_field(progress, "save_time", 1800))
        # the occupancy update runs eagerly between strides, so its cadence
        # ends strides too (the JAX trainer's non-folded path)
        cadences = (epoch_loss, epoch_val, epoch_save,
                    self.pipeline.dynamic_update_epoch if self.log_max_allowance else None, self.epoch_optim)
        t_start = t_window = last_save = time.time()
        epoch = self.start_epoch
        try:
            while epoch < self.total_epoch:
                if self.log_max_allowance:
                    self.pipeline.update_dynamic_bs(epoch, self.log_max_allowance)
                stride = self._stride_for(epoch, cadences)
                stats = self.train_steps(epoch, stride)
                epoch += stride

                if epoch % epoch_loss == 0:
                    self._warn_budget_overflow(stats)
                    dt = time.time() - t_window
                    t_window = time.time()
                    self.logger.add_log("epoch {:6d} | loss {:.5f} | psnr {:.2f} | {:.3f} s/iter | rays {}".format(
                        epoch, profiler.host_read(stats["loss"], "train.loss_log", float),
                        profiler.host_read(stats.get("psnr", 0.0), "train.loss_log", float), dt / epoch_loss,
                        stats["n_rays"]))
                if epoch_val > 0 and epoch % epoch_val == 0 and "val" in self.data:
                    self.valid_epoch(epoch)
                if epoch_save > 0 and epoch % epoch_save == 0:
                    self.save(["model_step{}".format(epoch), "latest"], epoch)
                if time.time() - last_save > save_time:
                    self.save(["latest"], epoch)
                    last_save = time.time()
        except KeyboardInterrupt:
            self.save(["latest"], epoch)
            self.logger.add_log("Interrupted; saved latest at epoch {}".format(epoch))
            raise
        self.save(["final"], self.total_epoch)
        self.logger.add_log("Training done in {:.1f} min".format((time.time() - t_start) / 60.0))
        return self
