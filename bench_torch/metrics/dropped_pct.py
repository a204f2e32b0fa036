"""The share of the steps' valid samples that the compaction's point
budget drops (``compact.dropped`` over ``compact.valid``), over a window
that ran with spans on."""


def read(r):
    c = (r.get("spans_window") or {}).get("counters", {})
    if not c.get("compact.valid"):
        return None
    return 100.0 * c.get("compact.dropped", 0) / c["compact.valid"]
