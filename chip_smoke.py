"""Smoke run of the arcnerf_torch serving path on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the root of the repository)

1. Requires CUDA; prints the card (nvidia-smi name and power limit), torch
   and CUDA versions.
2. Builds the CUDA kernels from arcnerf_torch/csrc.
3. Holds each kernel against its plain PyTorch version on the card at the
   serving shapes, and times both (CUDA events).
4. Drives the main path: ``arcnerf_torch.evaluate`` on an 800x800 Synthetic
   view of the NGP recipe (configs/expr/synthetic_ngp.yaml, full width,
   random weights from a seeded torch.Generator saved as a port checkpoint,
   occupancy of the scene's spheres at n_grid 128, per-ray cap 16). Checks
   the image, that every kernel launched in that run, and a 4096-ray crop
   against the plain path on the CPU; then times 3 renders.
5. Prints the kernel table as JSON, the card line, and as the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero. Outputs go to chiprun_out/chip_smoke/.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SEED = 0

# (rows, tolerance) per kernel comparison, and the slice tolerances
A_ROWS, A_TOL = 1 << 18, 2e-2  # bf16 flips from another summation order
B_POINTS, B_TOL = 1 << 18, 1e-5  # f32 sums in another order
C_RAYS, C_STREAM, C_TOL = 16384, 1 << 18, 1e-4  # sequential vs cumprod/sum order, relative
RGB_MAX, RGB_MEAN, DEPTH_MAX = 2e-2, 1e-3, 5e-2


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


def compare_fused_mlp(dev, gen):
    from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    rows = []
    total_ms = total_plain = worst = 0.0
    for label, dims in (("geo", [32, 64, 16]), ("radiance", [18, 64, 64, 3])):
        x = torch.randn((A_ROWS, dims[0]), generator=gen, device=dev)
        ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
              for i in range(len(dims) - 1)]
        out, ref = fused_mlp(x, ws), fused_mlp_reference(x, ws)
        check_close("fused_mlp " + label, out, ref, A_TOL, A_TOL)
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

    tot = torch.randint(0, 33, (C_RAYS,), generator=gen, device=dev)
    off = torch.cumsum(tot, 0) - tot
    cnt = torch.minimum((C_STREAM - off).clamp_min(0), tot)  # budget-clipped tail, as compaction makes it
    sigma = torch.randn((C_STREAM,), generator=gen, device=dev) * 20
    rgb = torch.rand((C_STREAM, 3), generator=gen, device=dev)
    # z ascends inside each ray's segment: a fixed-step ladder with gaps
    # of 0 (crushed deltas), 1 or 2 steps
    steps = torch.cumsum(torch.randint(0, 3, (C_STREAM,), generator=gen, device=dev), 0)
    ray_id = torch.repeat_interleave(torch.arange(C_RAYS, device=dev), cnt)
    z = 2.0 + torch.rand((C_STREAM,), generator=gen, device=dev)
    z[: ray_id.shape[0]] = 2.0 + 0.0068 * (steps[: ray_id.shape[0]] - steps[off[ray_id]]).float()
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from arcnerf_torch import evaluate
    from arcnerf_torch.models.base_modules.encoding import hash_encode
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.ops.fused_mlp import fused_mlp
    from arcnerf_torch.render.engine import RenderEngine
    from arcnerf_torch.render.ray_helper import segment_march
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.utils.cfgs import parse_configs

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
    for key, fn in (("A", compare_fused_mlp), ("B", compare_hash_encode), ("C", compare_segment_march)):
        rows, stats[key] = fn(dev, gen)
        for row in rows:
            print(row)
    torch.cuda.synchronize()

    # ------------------------------------------------------- the main path
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, "ngp_random.pt")
    argv = ["--configs", os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--model_pt", ckpt,
            "--device", "cuda:0", "--dir.eval_dir", os.path.join(OUT_DIR, "eval"), "--progress.max_samples_eval", "1",
            "--dataset.eval.type", "Synthetic", "--dataset.eval.n_imgs", "1", "--dataset.eval.wh", "[800,800]",
            "--dataset.eval.cam_radius", "2.5", "--dataset.eval.white_bkg", "True",
            "--dataset.eval.center_pixel", "True", "--model.obj_bound.eval_max_pts_per_ray", "16"]
    make_checkpoint(ckpt, argv)  # 64 MB: removed at the end

    fused_mlp.launches = hash_encode.launches = segment_march.launches = 0
    summary, results = evaluate.main(argv)
    torch.cuda.synchronize()
    launches = {"A": fused_mlp.launches, "B": hash_encode.launches, "C": segment_march.launches}
    print("main path launches:", launches, "eval summary:", summary)
    rgb = results[0]["rgb"]
    if rgb.shape != (800, 800, 3) or not np.isfinite(rgb).all():
        raise AssertionError("render: expected a finite (800, 800, 3) image, got {}".format(rgb.shape))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the main path never launched: {}".format(launches))

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

    meta = {
        "A": ("fused_mlp_fwd", "arcnerf_torch/csrc/fused_mlp.cu", "arcnerf_tpu/ops/fused_mlp.py:125"),
        "B": ("hash_encode_fwd", "arcnerf_torch/csrc/hash_encode.cu",
              "arcnerf_tpu/models/base_modules/encoding.py:544"),
        "C": ("segment_march_fwd", "arcnerf_torch/csrc/segment_march.cu", "arcnerf_tpu/render/ray_helper.py:328"),
    }
    kernels = [dict(name=meta[k][0], route="cuda", source=meta[k][1], replaces=meta[k][2], launches=launches[k],
                    **stats[k]) for k in ("A", "B", "C")]
    os.remove(ckpt)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
