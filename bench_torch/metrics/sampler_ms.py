"""Device milliseconds a frame launched inside ``model.sample`` (near and
far, the fix-step ladder, the occupancy mask and the cap) in the traced
window."""


def read(r):
    t = r.get("span_device_s", {}).get("model.sample")
    if not t or not r["units"]:
        return None
    return 1e3 * t / r["units"]
