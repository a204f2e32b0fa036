"""The readings the limits of the VolSDF training cell's check are set from,
on the cell's own sizes (``controls_neus.py``'s for the VolSDF driver): the
control (``reference.volsdf.CONTROL``, the GeoNet's matmuls with TF32
operands, put in the program's place) and the faults a cell can have,
planted in the reference put in the program's place, each against the
sound reference: the eikonal loss left out (the double backward missing),
one bisection of beta fewer (``beta_iter`` 9), one round of Algorithm 1
fewer (``n_iter`` 4), half of the batch left out of the losses, and a step
that leaves its state unchanged (each leaf's change reads 1: no run). One
JSON line a seed and reading.

    python3 bench_torch/controls_volsdf.py --workload train_volsdf --seeds <n> [<n> ...] [--rehearse]
"""

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def train_readings(ctx):
    import torch

    from bench_torch import check, traffic
    from bench_torch.drivers import train_volsdf
    from bench_torch.reference import volsdf

    p = ctx.workload["traffic"]
    spec = volsdf.Spec(ctx.model)
    views, _ = traffic.training_views(p["views"], ctx.seed, ctx.device)
    leaves = train_volsdf.weights(spec, ctx.seed, ctx.device)
    pool = {k: torch.cat([torch.from_numpy(v[k]) for v in views]).to(ctx.device) for k in ("img", "rays_o", "rays_d")}
    optim = ctx.config["optim"]
    sched = optim.get("lr_scheduler", {})
    n_rays = int(p["check_rays"])

    def run(prec=volsdf.F32, s=spec):
        gen = torch.Generator(device=ctx.device).manual_seed(traffic.derived_seed(ctx.seed, "draws"))
        losses, first, after, zs = volsdf.train_steps(s, leaves, pool, gen, n_rays, 3, float(optim["lr"]),
                                                      float(optim.get("eps", 1e-8)), float(sched.get("lr_gamma", 0.1)),
                                                      float(sched.get("lr_steps", [500000])[0]), prec)
        return zs, losses, check.leaf_norms(first), check.leaf_norms({k: after[k] - leaves[k] for k in after})

    def numbers(prog, ref):
        out = train_volsdf.sample_numbers(prog[0][0], ref[0][0])
        out.update(check.train_numbers(prog[1], ref[1], prog[2], ref[2], prog[3], ref[3]))
        return out

    def fewer(key):
        s = copy.copy(spec)
        setattr(s, key, getattr(spec, key) - 1)
        return s

    ref = run()
    out = {"control": numbers(run(volsdf.CONTROL), ref), "beta_iter_9": numbers(run(s=fewer("beta_iter")), ref),
           "n_iter_4": numbers(run(s=fewer("n_iter")), ref)}
    whole = volsdf.loss_of
    try:
        volsdf.loss_of = lambda rgb, img, normal: whole(rgb[: rgb.shape[0] // 2], img[: img.shape[0] // 2], normal)
        out["half_batch"] = numbers(run(), ref)
        volsdf.loss_of = lambda rgb, img, normal: (rgb - img).abs().mean() + 0.0 * normal.sum()
        out["no_eikonal"] = numbers(run(), ref)
    finally:
        volsdf.loss_of = whole
    out["state_unchanged"] = numbers(ref[:3] + ({k: 0.0 for k in ref[3]},), ref)
    return out


def main(argv=None):
    from bench_torch import run

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--rehearse", action="store_true")
    args = parser.parse_args(argv)
    _, _, config, workload = run.load_cell(args.workload, args.rehearse)

    import torch

    device = torch.device("cpu" if args.rehearse else "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        ctx = run.Ctx(argparse.Namespace(seed=seed), config, workload, device)
        for kind, numbers in train_readings(ctx).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": kind, "numbers": numbers,
                              "limits": workload["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
