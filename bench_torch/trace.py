"""The traced run's reading of a ``torch.profiler`` window: device busy
time (the union of the device operations inside the window), device time
by kernel group, and the breakdown (the device operations that took most
time; the idle gaps by what the host was doing, from the innermost host
operation over each gap's middle). Copied in spirit from the program's
smoke run (``device_split``) so that a later change to the program cannot
move it.
"""

import bisect
import contextlib
import time

import torch

from . import port

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(sink):
    """Profile the block (host and device); ``sink`` receives the reading."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sink.update(read(prof, wall))


def short_name(name):
    """A device operation's name without its arguments, at most 120 letters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def _union(spans):
    """The length of the union of sorted (start, end) spans."""
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def read(prof, wall):
    events = prof.events()
    window = next((ev for ev in events if ev.name == WINDOW), None)
    w0, w1 = (window.time_range.start, window.time_range.end) if window else (None, None)
    device, host = [], []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            if w0 is not None:
                s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((s, e, ev.name))
        elif ev.device_type == torch.autograd.DeviceType.CPU and ev.name != WINDOW:
            host.append((s, e, ev.name))
    by_name, by_group = {}, {}
    for s, e, name in device:
        short = short_name(name)
        by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e6
        group = port.kernel_of(name) or "plain"
        by_group[group] = by_group.get(group, 0.0) + (e - s) / 1e6
    busy_us = 0.0
    gaps = []
    if device:
        spans = sorted((s, e) for s, e, _ in device)
        busy_us = _union(spans)
        edge = w0 if w0 is not None else spans[0][0]
        for s, e in spans:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        end = w1 if w1 is not None else edge
        if end > edge:
            gaps.append((edge, end))
    idle = {}
    host.sort()
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        # the latest-started host operation still running at mid is the innermost
        i = bisect.bisect_right(starts, mid) - 1
        label = "python (no operation)"
        for s, e, name in reversed(host[max(0, i - 64):i + 1]):
            if e >= mid:
                label = name
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    window_s = (w1 - w0) / 1e6 if w0 is not None else wall
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy_us / 1e6, "by_group": by_group, "n_device_ops": len(device),
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps_top]}}
