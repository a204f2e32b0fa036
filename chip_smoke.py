"""Smoke run of the arcnerf_torch serving and training paths on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--profile]   (from the root of the repository)

1. Requires CUDA; prints the card (nvidia-smi name and power limit), torch
   and CUDA versions.
2. Builds the CUDA kernels A-F from arcnerf_torch/csrc.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, and times both (CUDA events).
4. Serving: ``arcnerf_torch.evaluate`` on an 800x800 Synthetic view of the
   NGP recipe (configs/expr/synthetic_ngp.yaml, full width, random weights
   from a seeded torch.Generator saved as a port checkpoint, occupancy of
   the scene's spheres at n_grid 128, per-ray cap 16). Checks the image,
   that kernels A-C launched in that run, and a 4096-ray crop against the
   plain path on the CPU; then times 3 renders.
5. Training: ``arcnerf_torch.train`` runs the full-width recipe for 400
   steps (24 Synthetic views at 128x128, dynamic batch up to 32768 rays,
   occupancy updates every 16 steps with warmup below 256). Checks that the
   loss is finite and falls, that the bitfield changed, that kernels A-F
   all launched, that one batch's loss and gradients match the plain path
   on the CPU, and that the held-out view renders at >= 20 dB PSNR through
   the serving path; prints the ray bucket, valid samples per ray and peak
   memory, then times 100 more steps (CUDA events: ms/step, rays/s). With
   --profile, also profiles 4 more steps (torch.profiler) and prints the
   device-time split and idle share.
6. Prints the kernel table as JSON, the card line, and as the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero. Outputs go to chiprun_out/chip_smoke/;
the training run's checkpoints go to experiments/ and are deleted.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
WORK_DIR = os.path.join(ROOT, "experiments", "chip_smoke")  # checkpoints: git-ignored, not copied back
SEED = 0

# (rows, tolerance) per kernel comparison, and the slice tolerances
A_ROWS, A_TOL = 1 << 18, 2e-2  # bf16 flips from another summation order
B_POINTS, B_TOL = 1 << 18, 1e-5  # f32 sums in another order
C_RAYS, C_STREAM, C_TOL = 16384, 1 << 18, 1e-4  # sequential vs cumprod/sum order, relative
# D, E, F: sums over many rows/samples in another order (atomics, cumprod),
# so the tolerance is relative to the largest value of each output
D_TOL, E_TOL, F_TOL = 1e-4, 1e-4, 1e-4
RGB_MAX, RGB_MEAN, DEPTH_MAX = 2e-2, 1e-3, 5e-2
TRAIN_STEPS, STEADY_STEPS, PSNR_FLOOR = 400, 100, 20.0
# one training step on the card vs the plain path on the CPU (same batch,
# no draws): bf16 flips in the MLPs and f32 sums in another order (atomics)
STEP_RAYS, STEP_LOSS_TOL, STEP_GRAD_TOL = 1024, 1e-3, 1e-2


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    """Mean ms per call over ``reps`` back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(out, ref):
    return float((out - ref).abs().max())


def check_close(name, out, ref, atol, rtol):
    bad = (out - ref).abs() > atol + rtol * ref.abs()
    if not torch.isfinite(out).all() or bool(bad.any()):
        raise AssertionError("{}: {} of {} values outside atol={} rtol={} (max abs err {})".format(
            name, int(bad.sum()), bad.numel(), atol, rtol, max_err(out, ref)))


def check_scaled(name, out, ref, tol):
    """|out - ref| <= tol * max|ref| everywhere; returns max abs err."""
    scale = float(ref.abs().max())
    err = max_err(out, ref)
    if not torch.isfinite(out).all() or err > tol * scale:
        raise AssertionError("{}: max abs err {} > {} * max|ref| {}".format(name, err, tol, scale))
    return err


def _chain(dims, gen, dev):
    return [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
            for i in range(len(dims) - 1)]


def compare_fused_mlp(dev, gen):
    from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_fwd, fused_mlp_reference

    rows = []
    total_ms = total_plain = worst = 0.0
    for label, dims in (("geo", [32, 64, 16]), ("radiance", [18, 64, 64, 3])):
        x = torch.randn((A_ROWS, dims[0]), generator=gen, device=dev)
        ws = _chain(dims, gen, dev)
        out, ref = fused_mlp(x, ws), fused_mlp_reference(x, ws)
        check_close("fused_mlp " + label, out, ref, A_TOL, A_TOL)
        # save_pre: the same output, and the bf16 pre-activations of the plain chain
        out_s, pre = fused_mlp_fwd(x, ws, save_pre=True)
        _, pre_ref = fused_mlp_reference(x, ws, save_pre=True)
        if not torch.equal(out_s, out):
            raise AssertionError("fused_mlp {}: save_pre changed the output".format(label))
        check_close("fused_mlp save_pre " + label, pre.float(), pre_ref.float(), A_TOL, A_TOL)
        ms, plain = time_ms(lambda: fused_mlp(x, ws)), time_ms(lambda: fused_mlp_reference(x, ws))
        rows.append("A fused_mlp {} {}: max abs err {:.3e} (tol {}), kernel {:.4f} ms, plain {:.4f} ms".format(
            label, "-".join(map(str, dims)), max_err(out, ref), A_TOL, ms, plain))
        total_ms, total_plain, worst = total_ms + ms, total_plain + plain, max(worst, max_err(out, ref))
    return rows, {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}


def compare_hash_encode(dev, gen):
    from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode, hash_encode_reference

    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    table = (torch.rand((16, 1 << 19, 2), generator=gen, device=dev) * 2 - 1).contiguous()
    xyz = torch.rand((B_POINTS, 3), generator=gen, device=dev) * 2 - 1
    rows, entry = [], None
    for variant in ("quad", "ngp"):
        args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, variant, True)
        out, ref = hash_encode(*args), hash_encode_reference(*args)
        check_close("hash_encode " + variant, out, ref, B_TOL, 0.0)
        ms, plain = time_ms(lambda: hash_encode(*args)), time_ms(lambda: hash_encode_reference(*args))
        rows.append("B hash_encode {} (2^18 pts, L=16, T=2^19, F=2): max abs err {:.3e} (tol {}), kernel {:.4f} ms, "
                    "plain {:.4f} ms".format(variant, max_err(out, ref), B_TOL, ms, plain))
        if variant == enc.variant:
            entry = {"max_abs_err": max_err(out, ref), "ms": ms, "plain_ms": plain}
    return rows, entry


def compare_segment_march(dev, gen):
    from arcnerf_torch.render.ray_helper import segment_march, segment_march_reference

    sigma, rgb, z, off, cnt = march_stream(dev, gen, C_RAYS, C_STREAM)
    bkg = torch.ones((C_RAYS, 3), device=dev)
    out = segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg)
    ref = segment_march_reference(sigma, rgb, z, off, cnt, bkg=bkg)
    err = 0.0
    for k in ("rgb", "depth", "mask", "trans_end"):
        check_close("segment_march " + k, out[k], ref[k], C_TOL, C_TOL)
        err = max(err, max_err(out[k], ref[k]))
    ms = time_ms(lambda: segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg))
    plain = time_ms(lambda: segment_march_reference(sigma, rgb, z, off, cnt, bkg=bkg))
    row = "C segment_march (16384 rays, 2^18 stream): max abs err {:.3e} (tol {} rel), kernel {:.4f} ms, " \
          "plain {:.4f} ms".format(err, C_TOL, ms, plain)
    return [row], {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def compare_fused_mlp_bwd(dev, gen):
    from arcnerf_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd

    rows = []
    total_ms = total_plain = worst = 0.0
    for label, dims in (("geo", [32, 64, 16]), ("radiance", [18, 64, 64, 3])):
        x = torch.randn((A_ROWS, dims[0]), generator=gen, device=dev)
        ws = _chain(dims, gen, dev)
        _, pre = fused_mlp_fwd(x, ws, save_pre=True)
        g = torch.randn((A_ROWS, dims[-1]), generator=gen, device=dev)
        dx, dws = fused_mlp_bwd(x, g, ws, pre)
        dx_ref, dws_ref = fused_mlp_bwd_reference(x, g, ws, pre)
        err = check_scaled("fused_mlp_bwd dX " + label, dx, dx_ref, D_TOL)
        for i, (a, b) in enumerate(zip(dws, dws_ref)):
            err = max(err, check_scaled("fused_mlp_bwd dW{} {}".format(i, label), a, b, D_TOL))
        ms = time_ms(lambda: fused_mlp_bwd(x, g, ws, pre))
        plain = time_ms(lambda: fused_mlp_bwd_reference(x, g, ws, pre))
        rows.append("D fused_mlp_bwd {} {}: max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} ms, "
                    "plain {:.4f} ms".format(label, "-".join(map(str, dims)), err, D_TOL, ms, plain))
        total_ms, total_plain, worst = total_ms + ms, total_plain + plain, max(worst, err)
    return rows, {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}


def compare_hash_encode_bwd(dev, gen):
    from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, hash_encode_bwd,
                                                           hash_encode_bwd_reference)

    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    xyz = torch.rand((B_POINTS, 3), generator=gen, device=dev) * 2 - 1
    g = torch.randn((B_POINTS, 32), generator=gen, device=dev)
    shape = (16, 1 << 19, 2)
    rows, entry = [], None
    for variant in ("quad", "ngp"):
        args = (xyz, g, shape, enc.resolutions, enc.aabb_min, enc.aabb_len, variant)
        err = check_scaled("hash_encode_bwd " + variant, hash_encode_bwd(*args), hash_encode_bwd_reference(*args),
                           E_TOL)
        ms, plain = time_ms(lambda: hash_encode_bwd(*args)), time_ms(lambda: hash_encode_bwd_reference(*args))
        rows.append("E hash_encode_bwd {} (2^18 pts, L=16, T=2^19, F=2): max abs err {:.3e} (tol {} x max|ref|), "
                    "kernel {:.4f} ms, plain {:.4f} ms".format(variant, err, E_TOL, ms, plain))
        if variant == enc.variant:
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain}
    return rows, entry


def march_stream(dev, gen, n_rays, k):
    """A compacted stream as the main path makes it: segments of 0-32
    samples, the last ones clipped by the budget, z ascending inside each
    segment on a fixed-step ladder with gaps of 0 (crushed deltas), 1 or 2
    steps."""
    tot = torch.randint(0, 33, (n_rays,), generator=gen, device=dev)
    off = torch.cumsum(tot, 0) - tot
    cnt = torch.minimum((k - off).clamp_min(0), tot)
    sigma = torch.randn((k,), generator=gen, device=dev) * 20
    rgb = torch.rand((k, 3), generator=gen, device=dev)
    steps = torch.cumsum(torch.randint(0, 3, (k,), generator=gen, device=dev), 0)
    ray_id = torch.repeat_interleave(torch.arange(n_rays, device=dev), cnt)
    z = 2.0 + torch.rand((k,), generator=gen, device=dev)
    z[: ray_id.shape[0]] = 2.0 + 0.0068 * (steps[: ray_id.shape[0]] - steps[off[ray_id]]).float()
    return sigma, rgb, z, off, cnt


def compare_segment_march_bwd(dev, gen):
    from arcnerf_torch.render.ray_helper import segment_march_bwd, segment_march_bwd_reference

    sigma, rgb, z, off, cnt = march_stream(dev, gen, C_RAYS, C_STREAM)
    bkg = torch.rand((C_RAYS, 3), generator=gen, device=dev)
    g_rgb = torch.randn((C_RAYS, 3), generator=gen, device=dev)
    g_depth, g_mask = (torch.randn((C_RAYS,), generator=gen, device=dev) for _ in range(2))
    args = (sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, False, bkg)
    (d_sigma, d_rgb), (r_sigma, r_rgb) = segment_march_bwd(*args), segment_march_bwd_reference(*args)
    err = max(check_scaled("segment_march_bwd d_sigma", d_sigma, r_sigma, F_TOL),
              check_scaled("segment_march_bwd d_rgb", d_rgb, r_rgb, F_TOL))
    ms, plain = time_ms(lambda: segment_march_bwd(*args)), time_ms(lambda: segment_march_bwd_reference(*args), 3)
    row = "F segment_march_bwd (16384 rays, 2^18 stream): max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} ms, " \
          "plain {:.4f} ms".format(err, F_TOL, ms, plain)
    return [row], {"max_abs_err": err, "ms": ms, "plain_ms": plain}


def make_checkpoint(path, argv):
    """Seeded random weights + the spheres' occupancy -> a port checkpoint."""
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.models import build_model
    from arcnerf_torch.utils.cfgs import parse_configs
    from arcnerf_torch.utils.model_io import save_model

    cfgs = parse_configs(argv)
    model = build_model(cfgs, generator=torch.Generator().manual_seed(SEED))
    bound_state = model.init_bound_state()
    vol = model.fg_model.get_obj_bound().get_obj_bound()
    bound_state["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(vol.get_n_grid(), float(vol.xyz_len[0])))
    save_model(path, model.state_dict(), bound_state, meta={}, step=0)


def kernel_counters():
    from arcnerf_torch.models.base_modules.encoding import hash_encode, hash_encode_bwd
    from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_bwd
    from arcnerf_torch.render.ray_helper import segment_march, segment_march_bwd

    return {"A": fused_mlp, "B": hash_encode, "C": segment_march, "D": fused_mlp_bwd, "E": hash_encode_bwd,
            "F": segment_march_bwd}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches(keys):
    counters = kernel_counters()
    return {k: counters[k].launches for k in keys}


def serve(dev):
    """The serving path on an 800x800 view; returns its launch counts."""
    from arcnerf_torch import evaluate
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.render.engine import RenderEngine
    from arcnerf_torch.utils.cfgs import parse_configs

    ckpt = os.path.join(WORK_DIR, "ngp_random.pt")
    argv = ["--configs", os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--model_pt", ckpt,
            "--device", "cuda:0", "--dir.eval_dir", os.path.join(OUT_DIR, "eval"), "--progress.max_samples_eval", "1",
            "--dataset.eval.type", "Synthetic", "--dataset.eval.n_imgs", "1", "--dataset.eval.wh", "[800,800]",
            "--dataset.eval.cam_radius", "2.5", "--dataset.eval.white_bkg", "True",
            "--dataset.eval.center_pixel", "True", "--model.obj_bound.eval_max_pts_per_ray", "16"]
    make_checkpoint(ckpt, argv)  # 64 MB, outside chiprun_out: removed at the end

    reset_launches()
    summary, results = evaluate.main(argv)
    torch.cuda.synchronize()
    launches = read_launches("ABC")
    print("serving path launches:", launches, "eval summary:", summary)
    rgb = results[0]["rgb"]
    if rgb.shape != (800, 800, 3) or not np.isfinite(rgb).all():
        raise AssertionError("render: expected a finite (800, 800, 3) image, got {}".format(rgb.shape))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the serving path never launched: {}".format(launches))

    # the same model on the CPU (plain versions) over a crop of the view
    cfgs = parse_configs(argv)
    model, bound_state = evaluate.load_for_eval(cfgs, dev)
    sample = get_dataset(cfgs.dataset, "data", "eval")[0]
    bkg = evaluate.eval_bkg_color(cfgs)
    crop = slice(400 * 800, 400 * 800 + 4096)  # the middle rows cross the spheres
    feed = {k: torch.as_tensor(sample[k][crop])[None] for k in ("rays_o", "rays_d")}
    feed["bkg_color"] = torch.tensor(bkg, dtype=torch.float32).expand(1, 4096, 3)
    model_cpu, bound_cpu = evaluate.load_for_eval(cfgs, torch.device("cpu"))
    with torch.inference_mode():
        cpu = model_cpu(feed, inference_only=True, bound_state=bound_cpu)
    gpu_rgb = torch.as_tensor(rgb.reshape(-1, 3)[crop])
    gpu_depth = torch.as_tensor(results[0]["depth"].reshape(-1)[crop])
    d_rgb = (gpu_rgb - cpu["rgb"][0]).abs()
    d_depth = float((gpu_depth - cpu["depth"][0]).abs().max())
    print("crop vs CPU plain path: rgb max {:.3e} mean {:.3e}, depth max {:.3e}".format(
        float(d_rgb.max()), float(d_rgb.mean()), d_depth))
    if float(d_rgb.max()) > RGB_MAX or float(d_rgb.mean()) > RGB_MEAN or d_depth > DEPTH_MAX:
        raise AssertionError("the card's render disagrees with the plain path on the crop")

    engine = RenderEngine(model, cfgs, bound_state, dev)
    engine.render_image(sample, bkg_color=bkg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.render_image(sample, bkg_color=bkg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    per_ray = int(engine.last_n_valid_pts) / (800 * 800)
    print("render 800x800: median {:.2f} ms (runs {}), peak {:.0f} MiB, valid samples/ray {:.3f}, chunk {}".format(
        statistics.median(times) * 1e3, ", ".join("{:.2f}".format(t * 1e3) for t in times), peak, per_ray,
        engine._chunk_for_mesh()))
    os.remove(ckpt)
    return launches


def train(profile=False):
    """The training path: the full-width recipe for TRAIN_STEPS steps
    through ``arcnerf_torch.train``; returns its launch counts."""
    from arcnerf_torch import train as train_entry

    expr = os.path.join(WORK_DIR, "train")
    argv = ["--configs", os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--device", "cuda:0",
            "--dir.expr_dir", expr, "--progress.epoch", str(TRAIN_STEPS), "--progress.epoch_loss", "50",
            "--progress.epoch_val", "-1", "--progress.epoch_save_checkpoint", "-1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("ABCDEF")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("training path launches:", launches)
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the training path never launched: {}".format(launches))

    losses = torch.stack(trainer.loss_history).float().cpu()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print("loss: first 20 steps {:.5f}, last 20 steps {:.5f}, all finite {}".format(
        first, last, bool(torch.isfinite(losses).all())))
    if not torch.isfinite(losses).all() or not last < first:
        raise AssertionError("training: the loss is not finite or did not fall")
    occ = float(trainer.bound_state["fg"]["bitfield"].float().mean())
    print("occupancy: {:.4f} of the voxels after {} steps".format(occ, TRAIN_STEPS))
    if occ >= 1.0:
        raise AssertionError("training: the occupancy bitfield never changed")

    print("train {} steps: wall {:.1f} s, bucket {} rays, valid samples/ray {:.3f}, peak {:.2f} GiB".format(
        TRAIN_STEPS, wall, trainer.pipeline.n_rays, trainer.pipeline.last_valid_per_ray, peak))
    check_step_against_cpu(trainer)
    val = trainer.valid_epoch(TRAIN_STEPS)
    print("held-out view after {} steps: PSNR {:.3f} dB, SSIM {:.4f} (floor {} dB)".format(
        TRAIN_STEPS, val["psnr"], val["ssim"], PSNR_FLOOR))
    if not val["psnr"] >= PSNR_FLOOR:
        raise AssertionError("training: held-out PSNR {} below {}".format(val["psnr"], PSNR_FLOOR))
    steady_steps(trainer)
    if profile:
        profile_steps(trainer)
    shutil.rmtree(expr)
    return launches


def steady_steps(trainer, n=STEADY_STEPS):
    """n more steps of the trained run, each bracketed by CUDA events (no
    host sync between steps): median and mean ms per step, rays/s at the
    bucket. The occupancy update keeps its cadence, so the mean carries it
    and the median does not."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    epoch0 = trainer.step
    marks[0].record()
    for i in range(n):
        trainer.train_step(epoch0 + i)
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]
    med = statistics.median(step_ms)
    n_rays = trainer.pipeline.n_rays
    print("steady steps {}-{}: median {:.3f} ms/step (mean {:.3f}), bucket {} rays, {:.0f} rays/s".format(
        epoch0, epoch0 + n - 1, med, statistics.mean(step_ms), n_rays, n_rays / med * 1e3))


def check_step_against_cpu(trainer):
    """Loss and gradients of one batch on the card (kernels A-F) against a
    CPU copy of the trained model (plain versions): relative loss error
    <= STEP_LOSS_TOL, relative norm error of each parameter's gradient <=
    STEP_GRAD_TOL. No jitter or noise (no generator), no optimizer step."""
    import copy

    feed = trainer.pipeline.sample(trainer.generator)
    feed = {k: v[:, :STEP_RAYS] for k, v in feed.items()}
    results = []
    for model, dev in ((trainer.model, trainer.device), (copy.deepcopy(trainer.model).cpu(), torch.device("cpu"))):
        bound = {name: {k: v.to(dev) for k, v in sub.items()} for name, sub in trainer.bound_state.items()}
        batch = {k: v.to(dev) for k, v in feed.items()}
        model.zero_grad(set_to_none=True)
        out = model(batch, inference_only=False, bound_state=bound)
        loss = trainer.loss_factory(batch, out)["sum"]
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                        int(out["n_valid_pts"])))
    trainer.model.zero_grad(set_to_none=True)
    (loss_k, grads_k, n_valid), (loss_p, grads_p, _) = results
    rel = {n: float((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)) for n, g in grads_p.items()}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print("one step, {} rays, {} valid samples, card vs CPU plain: loss {:.6f} vs {:.6f} (rel {:.2e}, tol {}), "
          "grad rel norm err max {:.2e} (tol {})".format(STEP_RAYS, n_valid, loss_k, loss_p, loss_rel, STEP_LOSS_TOL,
                                                          max(rel.values()), STEP_GRAD_TOL))
    if loss_rel > STEP_LOSS_TOL or max(rel.values()) > STEP_GRAD_TOL:
        raise AssertionError("training step: the card disagrees with the plain path: {}".format(rel))


def profile_steps(trainer, n=4):
    """torch.profiler over n more steps: device time by kernel, busy and idle."""
    from torch.profiler import ProfilerActivity, profile

    epoch0 = trainer.step + 1  # off the occupancy cadence
    trainer.train_step(epoch0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for e in range(epoch0 + 1, epoch0 + 1 + n):
            trainer.train_step(e)
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False))
    if not spans:
        print("profile: no device events recorded")
        return
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy, cur_s, cur_e = busy + (cur_e - cur_s), s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    print("profile of {} steps: device busy {:.2f} ms of a {:.2f} ms span ({:.1f} % idle), {} kernels".format(
        n, busy / 1e3, span / 1e3, 100.0 * (1 - busy / span), len(spans)))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print("  {:8.3f} ms/step {:5.1f} %  {}".format(us / 1e3 / n, 100.0 * us / total, name[:110]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from arcnerf_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda:0")
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    nvcc_s = cuda_lib.build(verbose=True)
    cuda_lib.lib()
    print("build: nvcc {:.1f} s, build+load {:.1f} s".format(nvcc_s, time.perf_counter() - t0))

    # -------------------------------------------- kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = {}
    for key, fn in (("A", compare_fused_mlp), ("B", compare_hash_encode), ("C", compare_segment_march),
                    ("D", compare_fused_mlp_bwd), ("E", compare_hash_encode_bwd), ("F", compare_segment_march_bwd)):
        rows, stats[key] = fn(dev, gen)
        for row in rows:
            print(row)
    torch.cuda.synchronize()

    # ------------------------------------------------------- the main paths
    os.makedirs(OUT_DIR, exist_ok=True)
    os.makedirs(WORK_DIR, exist_ok=True)
    serve(dev)
    launches = train(profile="--profile" in sys.argv[1:])

    meta = {
        "A": ("fused_mlp_fwd", "arcnerf_torch/csrc/fused_mlp.cu", "arcnerf_tpu/ops/fused_mlp.py:125"),
        "B": ("hash_encode_fwd", "arcnerf_torch/csrc/hash_encode.cu",
              "arcnerf_tpu/models/base_modules/encoding.py:544"),
        "C": ("segment_march_fwd", "arcnerf_torch/csrc/segment_march.cu", "arcnerf_tpu/render/ray_helper.py:328"),
        "D": ("fused_mlp_bwd", "arcnerf_torch/csrc/fused_mlp_bwd.cu", "arcnerf_tpu/ops/fused_mlp.py:172"),
        "E": ("hash_encode_bwd", "arcnerf_torch/csrc/hash_encode_bwd.cu",
              "arcnerf_tpu/models/base_modules/encoding.py:69"),
        "F": ("segment_march_bwd", "arcnerf_torch/csrc/segment_march_bwd.cu", "arcnerf_tpu/render/ray_helper.py:328"),
    }
    kernels = [dict(name=meta[k][0], route="cuda", source=meta[k][1], replaces=meta[k][2], launches=launches[k],
                    **stats[k]) for k in "ABCDEF"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
