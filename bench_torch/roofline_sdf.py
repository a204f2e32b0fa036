"""The yardstick of the NeuS cells' per-layer metrics, beside
``roofline.py`` (whose peaks, HBM rate and bound it uses): the bytes and
operations of the work the hash grid's input gradient (kernel K) and its
backward (kernel L) do, and of the NeuS chains, computed from the work
(points, entries, widths), never from the kernels.
"""

from . import roofline


def _hash_sizes(model):
    enc = model["geometry"]["encoder"]
    return enc["n_levels"], 1 << enc["hashmap_size"], enc["n_feat_per_entry"]


def hash_dx(model, points, entries):
    """K: xyz and dL/d(encoding) (N, L F) in, the ``entries`` of the f32
    table the points' corners reach, dx (N, 3) out; per point, level and
    corner 2F operations for the corner's term and 6 for its three axes."""
    n_levels, _, n_feat = _hash_sizes(model)
    return (points * (12 + n_levels * n_feat * 4 + 12) + entries * n_feat * 4,
            points * n_levels * 8 * (2.0 * n_feat + 6))


def hash_dx_bwd(model, points, entries):
    """L: xyz, g (N, L F) and g_dx (N, 3) in, the entries the corners reach
    read, d_g (N, L F) and the whole f32 table gradient out; per point,
    level and corner 6 operations for its derivative weight, 2F for the
    gather and 2F for the scatter's terms."""
    n_levels, table_size, n_feat = _hash_sizes(model)
    return (points * (12 + 2 * n_levels * n_feat * 4 + 12) + entries * n_feat * 4
            + n_levels * table_size * n_feat * 4, points * n_levels * 8 * (6 + 4.0 * n_feat))


def chains(model):
    """The layer widths of the geometry chain (plain f32) and the radiance
    chain (kernels A and D): its inputs [pts, view, normal, feature] as the
    mode names them."""
    enc, geo, rad = model["geometry"]["encoder"], model["geometry"], model["radiance"]
    n_in = 3 * sum(m in rad["mode"] for m in "pvn") + (rad["W_feat_in"] if "f" in rad["mode"] else 0)
    return ([enc["n_levels"] * enc["n_feat_per_entry"]] + [geo["W"]] * geo["D"] + [1 + geo["W_feat"]],
            [n_in] + [rad["W"]] * rad["D"] + [3])


def _weights(dims):
    return sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def step_flops(model, points):
    """The MLP operations of a training step over ``points`` kept sections:
    the geometry chain's forward (2 a weight), its input gradient (2), the
    backward of both (4 each: dX and dW), and the radiance chain's forward
    and backward (2 + 4)."""
    geo, rad = chains(model)
    return points * (12.0 * _weights(geo) + 6.0 * _weights(rad))


def occupancy_flops(model, points):
    """The geometry chain's forward and input gradient at the occupancy
    update's points."""
    return points * 4.0 * _weights(chains(model)[0])


def radiance_fwd(model, points):
    """Kernel A's training build over the radiance chain: x and y f32, the
    f32 weights, the bf16 hidden pre-activations written."""
    d = chains(model)[1]
    return (points * ((d[0] + d[-1]) * 4 + sum(d[1:-1]) * 2) + _weights(d) * 4, 2.0 * points * _weights(d))


def radiance_bwd(model, points):
    """Kernel D over the radiance chain: x, g, the pre-activations and the
    weights in, dX and dW out."""
    d = chains(model)[1]
    return (points * (2 * d[0] * 4 + d[-1] * 4 + sum(d[1:-1]) * 2) + 2 * _weights(d) * 4, 4.0 * points * _weights(d))


def bound_s(nbytes, flops, peak=roofline.F32_FLOP_S):
    return roofline.bound_s(nbytes, flops, peak)
