"""The program's host reads of device values (``host.reads``, every site)
a frame or a step, over a window that ran with spans on."""


def read(r):
    w = r.get("spans_window")
    if not w or not w["units"]:
        return None
    return sum(w["reads"].values()) / w["units"]
