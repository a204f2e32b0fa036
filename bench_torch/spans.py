"""The reading of the program's own spans and counters
(``arcnerf_torch.utils.profiler``) in a traced run:

- beside a ``torch.profiler`` window that ran with spans on: each device
  operation is put down to the innermost program span open when the host
  launched it (the launch is the host's runtime call that shares the
  operation's correlation id; both on the profiler's clock, which the
  spans share), so a CUDA graph's kernels fall to the span open over the
  graph's launch; and each idle gap of the device to the innermost span
  open over the gap's middle;
- over a window that ran with spans on and the profiler off: the host's
  time in each top span, less its host reads, and the counters.

Spans and operations come in as plain tuples, so the arithmetic is tested
on synthetic events.
"""

import bisect

import torch

# the host's runtime calls that launch device work, by the start of their name
LAUNCH_PREFIXES = ("cuda", "cu")


def door():
    """The program's tracing module (``enable``, ``disable``, ``collect``)."""
    from arcnerf_torch.utils import profiler

    return profiler


class SpanIndex:
    """The innermost span open at a time, over spans that nest (one host
    thread): the latest-started span at or before it, then up its parents
    to the first still open."""

    def __init__(self, spans):
        self.spans = spans
        self.order = sorted(range(len(spans)), key=lambda i: spans[i]["start_ns"])
        self.starts = [spans[i]["start_ns"] for i in self.order]

    def innermost(self, t_ns):
        k = bisect.bisect_right(self.starts, t_ns) - 1
        i = self.order[k] if k >= 0 else None
        while i is not None:
            s = self.spans[i]
            if s["end_ns"] is None or s["end_ns"] >= t_ns:
                return i
            i = s["parent"]
        return None

    def chain(self, i):
        """The names of span ``i`` and its ancestors, innermost first."""
        names = []
        while i is not None:
            names.append(self.spans[i]["name"])
            i = self.spans[i]["parent"]
        return names


def attribute(spans, launches, device_ops):
    """Device seconds by span name: each operation's time counts for the
    innermost span open at its launch and for each enclosing span
    (``inclusive``), and for the innermost alone (``own``). ``launches``
    maps a correlation id to the launch's time (ns); ``device_ops`` are
    (correlation id, start ns, end ns). Operations with no launch, or
    launched outside every span, fall to ``None``."""
    index = SpanIndex(spans)
    inclusive, own = {}, {}
    linked = 0.0
    for corr, s, e in device_ops:
        dt = (e - s) / 1e9
        t = launches.get(corr)
        i = index.innermost(t) if t is not None else None
        if t is not None:
            linked += dt
        names = index.chain(i) if i is not None else [None]
        own[names[0]] = own.get(names[0], 0.0) + dt
        for name in set(names):
            inclusive[name] = inclusive.get(name, 0.0) + dt
    total = sum((e - s) / 1e9 for _, s, e in device_ops)
    return {"inclusive": inclusive, "own": own, "linked_share": linked / total if total > 0 else None}


def idle_by_span(spans, gaps):
    """Idle seconds by the innermost span open over each gap's middle
    (``gaps``: (start ns, end ns)); ``None`` where no span is open."""
    index = SpanIndex(spans)
    out = {}
    for g0, g1 in gaps:
        i = index.innermost((g0 + g1) // 2)
        name = spans[i]["name"] if i is not None else None
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


def busy_gaps(device_ops, w0, w1):
    """The device's idle gaps inside [w0, w1] (ns) between the union of
    the operations' spans."""
    gaps, edge = [], w0
    for _, s, e in sorted(device_ops, key=lambda op: op[1]):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    return gaps


def profiled_events(prof, window_name):
    """(launches, device operations, window (start ns, end ns) or None) of
    a ``torch.profiler`` window, on the unix clock of the spans."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    launches, device, window = {}, [], None
    for ev in prof.events():
        s, e = t0 + int(ev.time_range.start * 1e3), t0 + int(ev.time_range.end * 1e3)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.id, s, e))
        elif ev.name == window_name:
            window = (s, e)
        elif ev.name.startswith(LAUNCH_PREFIXES):
            launches[ev.id] = s
    return launches, device, window


def read_profiled(prof, record, window_name):
    """The reading's span keys of a profiled window that ran with spans on:
    ``span_device_s`` (inclusive device seconds by span), ``span_own_s``,
    the share of device time linked to a launch, and the idle seconds by
    span with the share inside any span."""
    launches, device, window = profiled_events(prof, window_name)
    spans = record["spans"]
    att = attribute(spans, launches, device)
    out = {"span_device_s": {k: v for k, v in att["inclusive"].items() if k is not None},
           "span_own_s": {str(k): v for k, v in att["own"].items()}, "span_linked_share": att["linked_share"]}
    if device and window is not None:
        idle = idle_by_span(spans, busy_gaps(device, *window))
        total = sum(idle.values())
        out["span_idle_s"] = {str(k): v for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}
        out["span_idle_in_span"] = (total - idle.get(None, 0.0)) / total if total > 0 else None
    return out


def host_in_tops(record, top):
    """Host seconds in the top spans named ``top``, less the host reads
    inside them."""
    spans = record["spans"]
    tops = {i for i, s in enumerate(spans) if s["parent"] is None and s["name"] == top}
    inside = sum(s["end_ns"] - s["start_ns"] for s in spans if s["parent"] is None and s["name"] == top)
    reads = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == "host.read" and s["request"] in tops)
    return (inside - reads) / 1e9


def window_reading(record, units, top, wall_s):
    """The reading's ``spans_window`` of a window of ``units`` frames or
    steps, ``wall_s`` long, that ran with spans on and the profiler off."""
    return {"units": units, "wall_s": wall_s, "dispatch_s": host_in_tops(record, top), "reads": record["reads"],
            "counters": record["counters"], "n_spans": len(record["spans"])}
