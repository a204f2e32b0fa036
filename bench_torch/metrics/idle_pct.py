"""The device's idle share over the traced window: training strides (the
replays, the occupancy and dynamic batch updates between them, the host
work that feeds them) or frames (each ending in a synchronize, as the
client waits for it)."""


def read(r):
    if r["window_s"] <= 0 or r["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
