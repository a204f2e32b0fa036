"""The yardstick of the VolSDF cell's per-layer metrics, beside
``roofline.py`` (whose peaks, HBM rate and bound it uses): the operations
and bytes of the dense MLP work a training step does, computed from the
points the program counts (``volsdf.eval_pts``: the sampler's sdf
evaluations; ``sdf.normal_pts``: the samples and eikonal points whose
normals a step takes) and the chains' widths from the configuration,
never from the kernels that run it.

Each GEMM pass over a layer of (in, out) with N rows does 2 N in out
operations and moves its input, its output and the kernel once, in f32:
4 (N in + N out + in out) bytes; its least time is the larger of the two
at the f32 peak (TF32 off, the configuration's precision). The passes a
point takes:

- the sampler's points: the GeoNet's forward, 1 (2 operations a weight);
- the samples and eikonal points: the GeoNet's forward, the input gradient
  (the normal: a pass back through every layer) and the backward of both
  (a pass for the inputs' gradient and one for the kernels' of each), 6
  (12 operations a weight);
- the samples: the radiance net's forward and backward (inputs and
  kernels), 3 (6 operations a weight).
"""

from . import roofline


def chains(model):
    """The (in, out) of each layer of the GeoNet and the radiance net."""
    geo, rad = model["geometry"], model["radiance"]
    embed = 3 + 6 * int(geo["encoder"]["n_freqs"])
    skips, w, depth = list(geo["skips"]), int(geo["W"]), int(geo["D"])
    geo_dims, d = [], embed
    for i in range(depth + 1):
        out = 1 + int(geo["W_feat"]) if i == depth else (w - embed if i in skips else w)
        geo_dims.append((d, out))
        d = out + (embed if i in skips and i < depth else 0)
    enc = rad["encoder"]
    n_in = 0
    for m, width in (("p", 3 + 6 * int(enc["pts"]["n_freqs"])), ("v", 3 + 6 * int(enc["view"]["n_freqs"])), ("n", 3),
                     ("f", int(rad["W_feat_in"]))):
        n_in += width if m in rad["mode"] else 0
    rad_w = [n_in] + [int(rad["W"])] * int(rad["D"]) + [3]
    return geo_dims, list(zip(rad_w[:-1], rad_w[1:]))


def weights(dims):
    return sum(a * b for a, b in dims)


def samples_share(model):
    """The share of a training step's normal points that are samples (the
    rest are its two eikonal points a ray)."""
    rays = model["rays"]
    n = int(rays["n_sample"]) + int(rays["n_importance"])
    return n / (n + 2.0)


def passes(model, eval_pts, normal_pts):
    """[(layer dims, rows, passes)] of the step's GEMM work."""
    geo, rad = chains(model)
    return [(geo, eval_pts, 1), (geo, normal_pts, 6), (rad, normal_pts * samples_share(model), 3)]


def flops(model, eval_pts, normal_pts):
    """The GEMM operations: 2 a weight and pass."""
    return sum(2.0 * rows * n * weights(dims) for dims, rows, n in passes(model, eval_pts, normal_pts))


def least_seconds(model, eval_pts, normal_pts):
    """The least time of the GEMM work, layer by layer and pass by pass, at
    the f32 peak and the HBM rate."""
    total = 0.0
    for dims, rows, n in passes(model, eval_pts, normal_pts):
        for a, b in dims:
            total += n * roofline.bound_s(4.0 * (rows * a + rows * b + a * b), 2.0 * rows * a * b, roofline.F32_FLOP_S)
    return total


def work(model, eval_pts, normal_pts):
    return {"gemm_s": least_seconds(model, eval_pts, normal_pts), "mlp_flops": flops(model, eval_pts, normal_pts),
            "eval_pts": float(eval_pts), "normal_pts": float(normal_pts)}
