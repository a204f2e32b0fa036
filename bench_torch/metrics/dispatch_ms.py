"""Host milliseconds a frame the program spends dispatching: its time in
each top ``render.frame`` span, less the host reads inside it, over a
window that ran with spans on and the profiler off."""


def read(r):
    w = r.get("spans_window")
    if not w or not w["units"] or w["dispatch_s"] <= 0:
        return None
    return 1e3 * w["dispatch_s"] / w["units"]
