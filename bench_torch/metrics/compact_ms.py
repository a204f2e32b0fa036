"""Device milliseconds a frame launched inside ``model.compact`` (the
compaction's ranks and scatter, the point gathers and the scatter back)
in the traced window."""


def read(r):
    t = r.get("span_device_s", {}).get("model.compact")
    if not t or not r["units"]:
        return None
    return 1e3 * t / r["units"]
