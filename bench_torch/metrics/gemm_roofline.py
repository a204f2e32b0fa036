"""The dense MLP GEMMs' share of their roofline: the least time of the
traced window's GEMM work (``roofline_volsdf``: the sampler's GeoNet
forward, the samples' and eikonal points' forward, input gradient and both
backwards, the radiance net's forward and backward, from the points the
program counts) over the device time of the GEMM kernels, by name."""


def read(r):
    t = r.get("gemm_device_s")
    if not t or r.get("work", {}).get("gemm_s", 0.0) <= 0:
        return None
    return 100.0 * r["work"]["gemm_s"] / t
