"""The fused MLPs' share of their roofline: the least time of the traced
window's MLP work (kernel A over the points shaded, its training build
and kernel D over the steps' kept samples in training, its geometry chain
over the occupancy updates' points) over the device time of kernels A and
D."""


def read(r):
    t = r["by_group"].get("A", 0.0) + r["by_group"].get("D", 0.0)
    if t <= 0 or r["work"]["mlp_s"] <= 0:
        return None
    return 100.0 * r["work"]["mlp_s"] / t
