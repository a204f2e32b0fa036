"""The hash grid's share of its roofline: the least time of the traced
window's encoding work (kernel B over the points each call holds or the
steps' kept samples and the occupancy updates' points; kernel E over the
steps' kept samples, in training) over the device time of kernels B and
E."""


def read(r):
    t = r["by_group"].get("B", 0.0) + r["by_group"].get("E", 0.0)
    if t <= 0 or r["work"]["hash_s"] <= 0:
        return None
    return 100.0 * r["work"]["hash_s"] / t
