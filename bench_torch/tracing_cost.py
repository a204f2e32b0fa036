"""What the program's own tracing (``arcnerf_torch.utils.profiler``) costs
a cell when it is on. Not run by the benchmark's own runs.

    python3 bench_torch/tracing_cost.py --workload <cell> --seed <n> --blocks <b> --per <k> [--rehearse]

After the cell's set-up as ``run.py`` makes it, in one process: ``b``
pairs of blocks of ``k`` frames or strides, one with tracing off and one
with spans on (the profiler off), alternating which runs first, so that
both sides share the host's drift. One JSON line: each block's ms a frame
or rays a second, their medians, and the median of the pairs' on/off
ratios. The cost of the off state against the parent commit is not
measured here: that takes both commits (``run.py --trace 0`` on each).
"""

import argparse
import importlib
import json
import os
import statistics
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from bench_torch import run, spans  # noqa: E402


def block(driver, ctx, serve, per, start):
    """``per`` frames (from frame ``start``) or strides: ms a frame or rays
    a second."""
    ctx.sync()
    t0 = ctx.clock()
    rays = 0
    for i in range(per):
        if serve:
            driver.frame(start + i)
            ctx.sync()
        else:
            rays += driver.stride()[1]
    ctx.sync()
    dt = ctx.clock() - t0
    return 1e3 * dt / per if serve else rays / dt


def main(argv=None, out=None):
    out = out or sys.stdout
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--blocks", type=int, required=True)
    parser.add_argument("--per", type=int, required=True)
    parser.add_argument("--rehearse", action="store_true", help="on the CPU at the rehearsal's sizes")
    args = parser.parse_args(argv)
    run._set_caches()
    bench, cell, config, workload = run.load_cell(args.workload, args.rehearse)

    import torch

    device = torch.device("cpu" if args.rehearse else "cuda:0")
    if not args.rehearse:
        torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = run.Ctx(types.SimpleNamespace(seed=args.seed), config, workload, device)
    driver = importlib.import_module("bench_torch.drivers." + workload["driver"]).DRIVER(ctx)
    driver.setup()
    serve = workload["driver"] == "serve"
    profiler = spans.door()
    res, start = {"off": [], "on": []}, 0
    for b in range(args.blocks):
        for mode in ("off", "on") if b % 2 == 0 else ("on", "off"):
            if mode == "on":
                profiler.enable()
            try:
                res[mode].append(block(driver, ctx, serve, args.per, start))
            finally:
                profiler.disable()
            start += args.per
    ratios = [a / b for a, b in zip(res["on"], res["off"])]
    print(json.dumps({"cell": args.workload, "card": run.card_line() if not args.rehearse else None,
                      "unit": "ms/frame" if serve else "rays/s", "off": res["off"], "on": res["on"],
                      "median_off": statistics.median(res["off"]), "median_on": statistics.median(res["on"]),
                      "median_ratio_on_over_off": statistics.median(ratios), "ratios": ratios}), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
