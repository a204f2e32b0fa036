"""Device milliseconds a step or frame in operations that are neither
kernels A-F nor Adam: the plain PyTorch of the sampler, the compaction, the
occupancy update, the prepasses, the windowed tier's dense march and the
pipeline's glue."""


def read(r):
    if not r["units"] or "plain" not in r["by_group"]:
        return None
    return 1e3 * r["by_group"]["plain"] / r["units"]
