"""Device milliseconds a step launched inside ``train.occupancy`` (the
occupancy update, its points through kernels B and A included) over the
traced window's steps."""


def read(r):
    t = r.get("span_device_s", {}).get("train.occupancy")
    if not t or not r["units"]:
        return None
    return 1e3 * t / r["units"]
