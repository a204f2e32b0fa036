"""The numbers that decide ``correct``: what the timed path produced against
the plain reference (``reference/ngp.py``), each held to the limit the
workload file states.

Training: the first three steps of the object the window trains, each
step's loss, each leaf's first gradient (as Adam holds it after one step:
exp_avg / (1 - beta1)) and each leaf's change over the three steps, the
norms taken leaf by leaf and compared as gaps of norms against the larger
of the reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of both leaf numbers.

The occupancy update the check drives first (from the benchmark's leaves
and grid): the widest gap of a voxel's opacity outside the given grid, and
the count of voxels whose occupancy differs. Inside the given grid a voxel
keeps or decays its opacity as the update's draw from the occupied voxels
takes it or not, and that draw (``torch.multinomial`` on the card) is not
reproducible: two calls from one generator state differ in about 0.16 %
of their picks. Outside it only the uniform draw reaches a voxel, and
that is.

Serving: frames of the window drawn from the seed, against the reference's
render of the same camera: the mean and the widest gap of rgb, and the
mean gap of depth.
"""

import statistics

import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone
IDLE_LEAF = 1e-3


def _gap(prog, ref, scale):
    return abs(prog - ref) / scale


def train_numbers(prog_losses, ref_losses, prog_first, ref_first, prog_change, ref_change, note=None):
    """prog/ref_first, prog/ref_change: the norms by leaf name. ``note``
    receives each leaf's gaps and the leaves the rule leaves out."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    med_g = statistics.median(ref_first.values())
    med_c = statistics.median(ref_change.values())
    leaves = [k for k in ref_first if ref_first[k] >= IDLE_LEAF * med_g]
    grad = {k: _gap(prog_first[k], ref_first[k], max(ref_first[k], med_g)) for k in leaves}
    change = {k: _gap(prog_change[k], ref_change[k], max(ref_change[k], med_c)) for k in leaves}
    if note is not None:
        note("leaves left out (reference gradient under {} of the median leaf's): {}; gaps by leaf: gradient {}, "
             "change {}".format(IDLE_LEAF, sorted(set(ref_first) - set(leaves)),
                                {k: float("{:.3g}".format(v)) for k, v in grad.items()},
                                {k: float("{:.3g}".format(v)) for k, v in change.items()}))
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()), "change_gap": max(change.values())}


def occupancy_numbers(prog_opa, prog_bits, ref_opa, ref_bits, given):
    """``given``: the grid the update started from."""
    gap = (prog_opa.float() - ref_opa.float()).abs()[~given]
    return {"occ_gap": float(gap.max()), "occ_bits": float((prog_bits != ref_bits).sum())}


def leaf_norms(leaves):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in leaves.items()}


def frame_numbers(rgb, depth, ref_rgb, ref_depth):
    d_rgb = (rgb.float() - ref_rgb.float()).abs()
    return {"rgb_mae": float(d_rgb.mean()), "rgb_max": float(d_rgb.max()),
            "depth_mae": float((depth.float() - ref_depth.float()).abs().mean())}


def worst(numbers):
    """The largest of each number over a list of dicts."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def verdict(numbers, limits):
    """(correct, {name: {value, limit}}): every number at or under its
    limit and finite."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
