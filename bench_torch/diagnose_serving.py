"""Where a serving cell's spread comes from, and whether its made model
serves a trained model's traffic. Not run by the benchmark's own runs.

    python3 bench_torch/diagnose_serving.py window --workload <cell> --seed <n> --seconds <s>
    python3 bench_torch/diagnose_serving.py traffic --workload <cell> --seed <n> --frames <k> --train-steps <m>

``window``: the cell's set-up and window as ``run.py`` makes them, each
frame timed twice: on the host clock to a synchronize (as ``frame_ms``
is) and by CUDA events around it (the device's span of the frame), with
the caching allocator's counters read after it and the card's clocks,
power and throttle reasons sampled by ``nvidia-smi`` every half second.
One JSON line: the run's frame ms, the device span's, both first and last
quarters, the allocator's cudaMalloc calls and retries inside the window,
the clocks' range, and the host's load.

``traffic``: the orbit's first ``k`` frames from the cell's made model and
from a model the program trained for ``m`` strided steps on the cell's
scene (the training cell's views and recipe), each frame's distinct
points shaded, and for the windowed tier its alive rays a pass, with each
frame's time. One JSON line a model.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

SMI = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active",
       "--format=csv,noheader,nounits", "-lms", "500"]
ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free", "segment.all.current")


def quarters(xs):
    k = max(1, len(xs) // 4)
    return statistics.mean(xs[:k]), statistics.mean(xs[-k:])


def build(args):
    import torch

    from bench_torch import run
    from bench_torch.drivers.serve import Serving

    run._set_caches()
    _, _, config, workload = run.load_cell(args.workload, args.rehearse)
    device = torch.device("cpu" if args.rehearse else "cuda:0")
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = run.Ctx(argparse.Namespace(seed=args.seed), config, workload, device)
    return torch, ctx, Serving(ctx)


def window(args):
    torch, ctx, drv = build(args)
    cuda = ctx.device.type == "cuda"
    stats = torch.cuda.memory_stats if cuda else dict
    drv.setup()
    ctx.sync()
    smi = subprocess.Popen(SMI, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True) if cuda else None
    lines = []
    if smi:
        reader = threading.Thread(target=lambda: lines.extend(iter(smi.stdout.readline, "")), daemon=True)
        reader.start()
    load0, cpu0 = os.getloadavg(), os.times()
    a0 = stats()
    host, dev, mallocs = [], [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        f0 = time.perf_counter()
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        drv.frame(i)
        if cuda:
            e1.record()
        ctx.sync()
        host.append(1e3 * (time.perf_counter() - f0))
        dev.append(e0.elapsed_time(e1) if cuda else host[-1])
        mallocs.append(stats().get("num_device_alloc", 0))
        i += 1
    wall = time.perf_counter() - t0
    a1 = stats()
    cpu1, load1 = os.times(), os.getloadavg()
    if smi:
        smi.terminate()
        smi.wait()
        reader.join(timeout=5)
    rows = [ln.strip().split(", ") for ln in lines if ln.count(",") >= 4]
    clocks = [(float(r[0]), float(r[1]), float(r[2]), float(r[3]), r[4]) for r in rows if r[0].isdigit()]
    out = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds, "frames": i,
           "frame_ms": 1e3 * wall / i, "host_ms_median": statistics.median(host),
           "host_ms_quarters": quarters(host), "host_ms_min": min(host),
           "device_ms_median": statistics.median(dev), "device_ms_quarters": quarters(dev),
           "device_ms_min": min(dev), "device_ms_max": max(dev),
           "frames_with_a_cudamalloc": sum(1 for a, b in zip(mallocs, mallocs[1:]) if b > a),
           "alloc": {k: a1.get(k, 0) - a0.get(k, 0) for k in ALLOC},
           "sm_mhz": [min(c[0] for c in clocks), max(c[0] for c in clocks)] if clocks else None,
           "mem_mhz": [min(c[1] for c in clocks), max(c[1] for c in clocks)] if clocks else None,
           "power_w": [min(c[2] for c in clocks), max(c[2] for c in clocks)] if clocks else None,
           "temp_c": [min(c[3] for c in clocks), max(c[3] for c in clocks)] if clocks else None,
           "throttle": sorted({c[4] for c in clocks}),
           "process_cpu_s": (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system),
           "loadavg": [load0[0], load1[0]], "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    print(json.dumps(out), flush=True)


def frames(torch, drv, k):
    """Per frame: its ms, its distinct points shaded, its alive rays a pass."""
    from bench_torch import port

    out = []
    for i in range(k):
        rows = []
        unwrap = port.wrap_hash_encode(rows.append)
        try:
            drv.ctx.sync()
            t0 = time.perf_counter()
            o, d = drv.rays[i % len(drv.rays)]
            sample = {"rays_o": o, "rays_d": d, "H": drv.h, "W": drv.w}
            if drv.tier == "exact":
                drv.engine.render_image(sample, bkg_color=drv.bkg)
                alive = None
            else:
                alive = drv.engine.render_image_windowed(sample, bkg_color=drv.bkg, **drv.render_p)[1]["alive_per_pass"]
            drv.ctx.sync()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            unwrap()
        pts = sum(int(torch.unique(x, dim=0).shape[0]) for x in rows)
        out.append({"ms": ms, "points": pts, "alive_per_pass": list(alive) if alive else None})
    return out


def traffic(args):
    import tempfile

    import numpy as np

    from bench_torch import port, run, traffic as tr

    torch, ctx, drv = build(args)
    made = frames(torch, drv, args.frames)
    # the training cell's recipe and views on the same configuration
    _, _, _, train_w = run.load_cell("train_" + ctx.workload["config"], args.rehearse)
    tree = dict(ctx.config)
    tree["progress"] = dict(tree["progress"], scan_steps=16, epoch=args.train_steps)
    p = train_w["traffic"]
    views, held = tr.training_views(p["views"], args.seed, ctx.device)
    leaves = tr.weights(ctx.model, p["weights"], args.seed, ctx.device)
    with tempfile.TemporaryDirectory(prefix="bench_diag_") as tmp:
        t = port.trainer(tree, ctx.device, tr.derived_seed(args.seed, "draws"), tmp, views, leaves)
        t.train()
        img = t.render_image(held, bkg_color=np.ones(3, dtype=np.float32))["rgb"].reshape(-1, 3).float()
        psnr = float(-10.0 * torch.log10(((img - held["img"].float()) ** 2).mean()))
        drv.engine = t.engine
        t.engine.bound_state = t.bound_state
        drv.engine.set_render_cap(drv.cap, window=drv.tier == "windowed")
        trained = frames(torch, drv, args.frames)
        occupied = float(t.bound_state["fg"]["bitfield"].float().mean())
    scene_occ = float(drv.bits.float().mean())
    for name, fr, occ, extra in (("made", made, scene_occ, {}),
                                 ("trained", trained, occupied, {"steps": args.train_steps, "psnr": psnr})):
        print(json.dumps(dict({"workload": args.workload, "seed": args.seed, "model": name, "occupied_share": occ,
                               "points_median": statistics.median(f["points"] for f in fr[1:]),
                               "ms_median": statistics.median(f["ms"] for f in fr[1:]), "frames": fr}, **extra)),
              flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("window", "traffic"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--train-steps", type=int, default=400)
    parser.add_argument("--rehearse", action="store_true", help="on the CPU at the rehearsal's tiny sizes")
    args = parser.parse_args(argv)
    (window if args.mode == "window" else traffic)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
