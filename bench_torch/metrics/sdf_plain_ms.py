"""Device milliseconds a NeuS step in operations that are none of kernels
A-F, Adam, and the hash grid's input gradient and its backward (K, L): the
plain geometry chain and its derivatives, the NeuS alpha and the losses'
elementwise work, and the glue."""


def read(r):
    kernels = r.get("sdf_kernel_s")
    if kernels is None or not r["units"] or "plain" not in r["by_group"]:
        return None
    return 1e3 * (r["by_group"]["plain"] - sum(kernels.values())) / r["units"]
