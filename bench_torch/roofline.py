"""The yardstick of the per-layer metrics: the card's published peaks and
the bytes and operations of each layer's work, computed from the work (the
points, rows and samples the inputs need), never from the kernel that runs
it, so that a later kernel is judged against the same work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W. A
bound is the larger of two times: bytes over the HBM rate and operations
over the peak of the arithmetic the recipe states. Each input byte counts
once and each output byte once.
"""

HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12


def bound_s(nbytes, flops, peak):
    """The least seconds of ``nbytes`` moved and ``flops`` done at ``peak``."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def mlp_chains(model):
    """The layer widths of the geometry and the radiance chains."""
    enc, geo, rad = model["geometry"]["encoder"], model["geometry"], model["radiance"]
    return ([enc["n_levels"] * enc["n_feat_per_entry"]] + [geo["W"]] * geo["D"] + [1 + geo["W_feat"]],
            [3 + rad["W_feat_in"]] + [rad["W"]] * rad["D"] + [3])


def _weights(dims):
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def mlp_flops_per_sample(model, chains=(0, 1)):
    """Forward operations of the chains for one sample: 2 a weight."""
    return sum(2 * _weights(mlp_chains(model)[c]) for c in chains)


def mlp_fwd(model, points, save_pre=False, chains=(0, 1)):
    """Kernel A's work over ``points`` samples through the ``chains`` (0
    geometry, 1 radiance): (bytes, operations). In: x (f32) and the f32
    weights; out: y (f32) and, in the training build, the bf16 hidden
    pre-activations."""
    nbytes = flops = 0.0
    for d in [mlp_chains(model)[c] for c in chains]:
        nbytes += points * (d[0] + d[-1]) * 4 + _weights(d) * 4
        if save_pre:
            nbytes += points * sum(d[1:-1]) * 2
        flops += 2.0 * points * _weights(d)
    return nbytes, flops


def mlp_bwd(model, points):
    """Kernel D's work: x, g (f32), the bf16 pre-activations and the
    weights in; dX (f32) and dW out; dX and dW each 2 operations a weight."""
    nbytes = flops = 0.0
    for d in mlp_chains(model):
        nbytes += points * (2 * d[0] * 4 + d[-1] * 4 + sum(d[1:-1]) * 2) + 2 * _weights(d) * 4
        flops += 4.0 * points * _weights(d)
    return nbytes, flops


def _hash_sizes(model):
    enc = model["geometry"]["encoder"]
    return enc["n_levels"], 1 << enc["hashmap_size"], enc["n_feat_per_entry"]


def hash_fwd(model, points, entries):
    """Kernel B's work: xyz in, (N, L F) f32 out, and the ``entries`` of the
    f32 table that the points' corners reach; 2 operations a corner and
    feature."""
    n_levels, _, n_feat = _hash_sizes(model)
    return (points * (12 + n_levels * n_feat * 4) + entries * n_feat * 4,
            points * n_levels * 8 * n_feat * 2.0)


def hash_bwd(model, points):
    """Kernel E's work: xyz and g (N, L F) in, the whole f32 table gradient
    out; 2 operations a corner and feature."""
    n_levels, table_size, n_feat = _hash_sizes(model)
    return (points * (12 + n_levels * n_feat * 4) + n_levels * table_size * n_feat * 4,
            points * n_levels * 8 * n_feat * 2.0)
