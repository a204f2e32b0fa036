"""The readings the limits of a NeuS training cell's check are set from,
on the cell's own sizes (``controls.py``'s for the NeuS driver): the
control (``reference.neus.CONTROL``, every precision the configuration
states stepped down once, put in the program's place) and the faults a
cell can have, planted in the reference put in the program's place, each
against the reference at the stated precision (``reference.neus.STATED``):
a step that leaves its state unchanged (each leaf's change and EMA gap
read 1, an occupancy update that returns the grid it was given: no run);
the update's answer altered (one voxel's occupancy flipped); half of the
batch left out of the losses; the eikonal loss left out (the double
backward missing). One JSON line a seed and reading.

    python3 bench_torch/controls_neus.py --workload <cell> --seeds <n> [<n> ...] [--rehearse]
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
    from bench_torch.drivers import train_neus
    from bench_torch.reference import neus

    if ctx.device.type == "cpu":
        ctx.workload = dict(ctx.workload, traffic=train_neus.rehearsal_traffic(ctx.workload["traffic"]))
    p = ctx.workload["traffic"]
    spec = neus.Spec(ctx.model)
    views, _ = traffic.training_views(p["views"], ctx.seed, ctx.device)
    leaves = train_neus.weights(ctx.model, p["weights"], ctx.seed, ctx.device)
    pool = {k: torch.cat([torch.from_numpy(v[k]) for v in views]).to(ctx.device)
            for k in ("img", "mask", "rays_o", "rays_d")}
    bits0 = scene.bitfield(spec.n_grid, spec.side).to(ctx.device)
    opa0 = bits0.to(torch.float32) * train_neus.SCENE_OPACITY
    optim = ctx.config["optim"]
    decay = float(optim["ema_decay"])
    n_rays = int(p["check_rays"])

    def run(prec):
        gen = torch.Generator(device=ctx.device).manual_seed(traffic.derived_seed(ctx.seed, "draws"))
        opa, bits = neus.occupancy_update(spec, leaves, opa0, bits0, gen, prec=prec)
        losses, first, after, shadow = neus.train_steps(spec, leaves, pool, bits, gen, n_rays, 3, float(optim["lr"]),
                                                        float(optim["eps"]), float(optim.get("weight_decay", 0.0)),
                                                        decay, prec)
        return ((opa, bits), losses, check.leaf_norms(first),
                check.leaf_norms({k: after[k] - leaves[k] for k in after}),
                check.leaf_norms({k: v - (1 - decay**3) * leaves[k] for k, v in shadow.items()}))

    def numbers(prog, ref):
        out = check.occupancy_numbers(*prog[0], *ref[0], bits0)
        out.update(check.train_numbers(prog[1], ref[1], prog[2], ref[2], prog[3], ref[3]))
        out["ema_gap"] = train_neus.ema_gap(prog[4], ref[4], ref[2])
        return out

    ref = run(neus.STATED)
    out = {"control": numbers(run(neus.CONTROL), ref)}
    whole = neus.losses
    try:
        neus.losses = lambda rgb, opacity, normal, img, mask: whole(rgb[: rgb.shape[0] // 2],
                                                                   opacity[: opacity.shape[0] // 2], normal,
                                                                   img[: img.shape[0] // 2], mask[: mask.shape[0] // 2])
        out["half_batch"] = numbers(run(neus.STATED), ref)
        neus.losses = lambda rgb, opacity, normal, img, mask: whole(rgb, opacity, normal[:0], img, mask)
        out["no_eikonal"] = numbers(run(neus.STATED), ref)
    finally:
        neus.losses = whole
    out["state_unchanged"] = numbers(((opa0, bits0),) + ref[1:3] + ({k: 0.0 for k in ref[3]},
                                                                    {k: 0.0 for k in ref[4]}), ref)
    flipped = ref[0][1].clone()
    flipped.view(-1)[flipped.numel() // 2] ^= True
    out["grid_altered"] = numbers(((ref[0][0], flipped),) + ref[1:], ref)
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
