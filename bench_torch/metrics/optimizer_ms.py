"""Device milliseconds a step under ``train.optimizer`` (the rate, the
optimizer's step and the EMA) over the traced window's steps; inside a
captured step's replay, read through the step's layer map
(``graph_spans.py``)."""


def read(r):
    t = r.get("span_device_s", {}).get("train.optimizer")
    if not t or not r["units"]:
        return None
    return 1e3 * t / r["units"]
