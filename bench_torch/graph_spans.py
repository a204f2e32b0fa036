"""The program's spans over a profiled window in which CUDA graphs replay.

``spans.py`` puts a replay's device operations on the replay span: a replay
runs no Python, so no span opens inside it. The program maps each graph as
it captures it (``arcnerf_torch.utils.profiler.capturing``): the span path
of every device node, in the capture's order, which ``collect()`` returns
under ``graphs`` for the graphs its replay spans name (attribute
``graph``). Here a device operation whose launch is a graph launch inside
such a span is the k-th of that launch's operations by start time, and
goes under the k-th node's span path, below the replay span. A replay
whose operation count differs from its map's node count stays on the
replay span whole and counts in ``span_unmapped_replays``. Every other
operation is read as ``spans.attribute`` reads it.

Spans and operations come in as plain tuples, so the arithmetic is tested
on synthetic events.
"""

import torch

from . import spans

# the host's runtime calls that launch a graph, by the start of their name
GRAPH_LAUNCH_PREFIXES = ("cudaGraphLaunch", "cuGraphLaunch")


def attribute(spans_, graphs, launches, device_ops):
    """Device seconds by span name, as ``spans.attribute`` gives them
    (``inclusive``, ``own``, ``linked_share``), with each replay of a
    mapped graph resolved through its map, and ``unmapped_replays``.
    ``launches`` maps a correlation id to (the launch's time in ns, its
    name); ``graphs`` is ``collect()["graphs"]``."""
    index = spans.SpanIndex(spans_)
    inclusive, own = {}, {}
    linked = 0.0

    def add(names, dt):
        own[names[0]] = own.get(names[0], 0.0) + dt
        for name in set(names):
            inclusive[name] = inclusive.get(name, 0.0) + dt

    replays = {}  # correlation id of a mapped graph's launch -> (replay span's chain, map, [(start, end)])
    for corr, s, e in device_ops:
        dt = (e - s) / 1e9
        launch = launches.get(corr)
        i = index.innermost(launch[0]) if launch is not None else None
        if launch is not None:
            linked += dt
        chain = index.chain(i) if i is not None else [None]
        graph = spans_[i]["attrs"].get("graph") if i is not None else None
        if graph in graphs and launch[1].startswith(GRAPH_LAUNCH_PREFIXES):
            replays.setdefault(corr, (chain, graphs[graph], []))[2].append((s, e))
        else:
            add(chain, dt)
    unmapped = 0
    for chain, layers, ops in replays.values():
        if len(ops) != len(layers):
            unmapped += 1
            for s, e in ops:
                add(chain, (e - s) / 1e9)
            continue
        for (s, e), path in zip(sorted(ops), layers):
            add(path[::-1] + chain, (e - s) / 1e9)
    total = sum((e - s) / 1e9 for _, s, e in device_ops)
    return {"inclusive": inclusive, "own": own, "linked_share": linked / total if total > 0 else None,
            "unmapped_replays": unmapped}


def profiled_events(prof, window_name):
    """(launches {correlation id: (ns, name)}, device operations, window
    (start ns, end ns) or None) of a ``torch.profiler`` window, on the unix
    clock of the spans: ``spans.profiled_events`` with each launch's name."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    launches, device, window = {}, [], None
    for ev in prof.events():
        s, e = t0 + int(ev.time_range.start * 1e3), t0 + int(ev.time_range.end * 1e3)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.id, s, e))
        elif ev.name == window_name:
            window = (s, e)
        elif ev.name.startswith(spans.LAUNCH_PREFIXES):
            launches[ev.id] = (s, ev.name)
    return launches, device, window


def read_profiled(prof, record, window_name):
    """``spans.read_profiled``'s keys, the replays resolved through the
    record's graphs, and ``span_unmapped_replays``."""
    launches, device, window = profiled_events(prof, window_name)
    att = attribute(record["spans"], record.get("graphs", {}), launches, device)
    out = {"span_device_s": {k: v for k, v in att["inclusive"].items() if k is not None},
           "span_own_s": {str(k): v for k, v in att["own"].items()}, "span_linked_share": att["linked_share"],
           "span_unmapped_replays": att["unmapped_replays"]}
    if device and window is not None:
        idle = spans.idle_by_span(record["spans"], spans.busy_gaps(device, *window))
        total = sum(idle.values())
        out["span_idle_s"] = {str(k): v for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}
        out["span_idle_in_span"] = (total - idle.get(None, 0.0)) / total if total > 0 else None
    return out
