"""Device milliseconds a VolSDF step in operations that are none of the
dense GEMMs, kernels A-F and Adam: the error-bound sampler's bisections,
sorts and searches, softplus and its derivatives, the density, the losses
and the glue."""


def read(r):
    t = r.get("plain_device_s")
    if t is None or not r["units"]:
        return None
    return 1e3 * t / r["units"]
