"""The readings that the limits of a cell's check are set from, on the
cell's own sizes: the control (the reference computed in the precision
below the one the configuration states, ``reference.ngp.CONTROL``, put in
the program's place) and the faults a cell can have, planted in the
reference put in the program's place, each against the float32 reference.

    python3 bench_torch/controls.py --workload <cell> --seeds <n> [<n> ...] [--rehearse]

Training cells: the control's occupancy update and three steps; a step
that leaves its state unchanged (every change 0, so each leaf's change gap
reads 1, and an occupancy update that returns the grid it was given: no
run); the update's answer altered where it is produced (one voxel's
occupancy flipped: one voxel differs, no run); half of the batch left
out, the mean taken over the rest. Serving cells:
the control's frames; an answer altered where it is produced (one pixel's
colour off by 0.1: its widest gap reads 0.1, no run). One JSON line a seed
and reading. The benchmark's own runs never run this; the sound program's
readings come from those runs.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def train_readings(ctx):
    import torch

    from bench_torch import check, scene, traffic
    from bench_torch.drivers.train import SCENE_OPACITY
    from bench_torch.reference import ngp

    p = ctx.workload["traffic"]
    views, _ = traffic.training_views(p["views"], ctx.seed, ctx.device)
    leaves = traffic.weights(ctx.model, p["weights"], ctx.seed, ctx.device)
    pool = {k: torch.cat([torch.from_numpy(v[k]) for v in views]).to(ctx.device)
            for k in ("img", "mask", "rays_o", "rays_d")}
    bits0 = scene.bitfield(ctx.spec.n_grid, ctx.spec.side).to(ctx.device)
    opa0 = bits0.to(torch.float32) * SCENE_OPACITY
    optim = ctx.config["optim"]
    n_rays = int(p["check_rays"])

    def run(prec):
        gen = torch.Generator(device=ctx.device).manual_seed(traffic.derived_seed(ctx.seed, "draws"))
        opa, bits = ngp.occupancy_update(ctx.spec, leaves, opa0, bits0, gen, prec)
        losses, first, after = ngp.train_steps(ctx.spec, leaves, pool, bits, gen, n_rays, 3, float(optim["lr"]),
                                               float(optim["eps"]), prec)
        return (opa, bits), losses, check.leaf_norms(first), check.leaf_norms({k: after[k] - leaves[k]
                                                                                for k in after})

    def numbers(prog, ref):
        out = check.occupancy_numbers(*prog[0], *ref[0], bits0)
        out.update(check.train_numbers(*[x for pair in zip(prog[1:], ref[1:]) for x in pair]))
        return out

    ref = run(ngp.F32)
    out = {"control": numbers(run(ngp.CONTROL), ref)}
    whole = ngp.huber
    ngp.huber = lambda pred, gt: whole(pred[: pred.shape[0] // 2], gt[: gt.shape[0] // 2])
    try:
        out["half_batch"] = numbers(run(ngp.F32), ref)
    finally:
        ngp.huber = whole
    out["state_unchanged"] = numbers(((opa0, bits0),) + ref[1:3] + ({k: 0.0 for k in ref[3]},), ref)
    flipped = ref[0][1].clone()
    flipped.view(-1)[flipped.numel() // 2] ^= True
    out["grid_altered"] = numbers(((ref[0][0], flipped),) + ref[1:], ref)
    return out


def serve_readings(ctx):
    import torch

    from bench_torch import check, scene, traffic
    from bench_torch.drivers.serve import WHITE
    from bench_torch.reference import ngp

    p = ctx.workload["traffic"]
    leaves = traffic.weights(ctx.model, p["weights"], ctx.seed, ctx.device)
    bits = scene.bitfield(ctx.spec.n_grid, ctx.spec.side).to(ctx.device)
    c2ws = traffic.orbit(p["orbit"], ctx.seed, ctx.device)
    wh = p["orbit"]["wh"]
    bkg = torch.tensor(WHITE, device=ctx.device)
    cap = p["render"].get("cap") if p["render"]["tier"] == "exact" else None
    numbers = []
    for i in (0, len(c2ws) // 2):
        o, d = scene.camera_rays(c2ws[i], int(wh[0]), int(wh[1]))
        ref = ngp.render_frame(ctx.spec, leaves, bits, o, d, bkg, cap=cap, block=4096)
        ctl = ngp.render_frame(ctx.spec, leaves, bits, o, d, bkg, cap=cap, block=4096, prec=ngp.CONTROL)
        numbers.append(check.frame_numbers(ctl[0], ctl[1], ref[0], ref[1]))
    altered = ref[0].clone()
    altered[altered.shape[0] // 2, 0] += 0.1
    return {"control": check.worst(numbers), "answer_altered": check.frame_numbers(altered, ref[1], ref[0], ref[1])}


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
        fn = train_readings if workload["driver"] == "train" else serve_readings
        for kind, numbers in fn(ctx).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": kind, "numbers": numbers,
                              "limits": workload["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
