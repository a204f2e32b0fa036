"""Spans and counters inside the program: where the host spends a frame or
a stride, which layer launched each piece of device work, and what each
layer counts.

Counterpart of ``arcnerf_tpu/utils/profiler.py``, whose ``annotate`` is
``span`` here; the rest of that file has no counterpart (the trainer logs
s/iter, and ``torch.profiler`` records device traces).

Tracing is off until ``enable()``, and ``disable()`` turns it off again;
nothing else turns it on. Off, ``span`` costs one flag check and returns a
shared no-op context, ``count`` returns at once, and ``host_read`` only
does the read it wraps: no clock read, no profiler annotation, no device
operation and no host read of its own. On:

- ``span(name, **attrs)`` records its name, start and end, its parent span
  and its request (the enclosing top span: one frame, or one stride) in
  memory. Times are unix nanoseconds, the clock of ``torch.profiler``'s
  events: an event's ``time_range`` (µs) plus the profile's
  ``trace_start_ns`` is on it. While a ``torch.profiler`` is active, the
  span also enters a profiler annotation of the same name, so a profile
  shows the program's layers.
- ``count(name, value)`` adds to a counter: a device tensor is summed on
  the device, a host number on the host; nothing is read until
  ``collect()``.
- ``count_compact(n_valid, budget)`` counts the compaction's valid samples
  and those its point budget drops.
- ``host_read(value, site, convert)`` counts the read under its site and
  times it as a ``host.read`` span.

Names are dotted by layer (``render.frame``, ``model.sample``,
``train.replay``, ...). The captured training step calls ``span`` but
never ``count``: a span has no device operation, so a CUDA graph replays
the same kernels with tracing on or off.
"""

import contextlib
import json
import time

import torch

_on = False
_spans = []  # [name, start_ns, end_ns, parent index, request index, attrs]
_open = []  # indices of the open spans, innermost last
_host = {}  # counter -> host sum
_device = {}  # counter -> device tensor sum
_reads = {}  # site -> reads
_OFF = contextlib.nullcontext()


def enable():
    """Start a fresh record and turn tracing on."""
    global _on
    _spans.clear()
    _open.clear()
    _host.clear()
    _device.clear()
    _reads.clear()
    _on = True


def disable():
    """Turn tracing off; the record stays for ``collect()``."""
    global _on
    _on = False


def active():
    """Whether tracing is on: callers test it before they compute a device
    value only a counter would use."""
    return _on


class _Span:
    __slots__ = ("name", "attrs", "index", "annotation")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.annotation = name, attrs, None

    def __enter__(self):
        # the annotation encloses the span's clock reads
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch._C._profiler._RecordFunctionFast(self.name)
            self.annotation.__enter__()
        parent = _open[-1] if _open else None
        self.index = len(_spans)
        _spans.append([self.name, time.time_ns(), None, parent,
                       self.index if parent is None else _spans[parent][4], self.attrs])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _spans[self.index][2] = time.time_ns()
        _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name, **attrs):
    """A context manager: the named span while tracing is on, else a no-op."""
    return _Span(name, attrs) if _on else _OFF


def count(name, value):
    """Add ``value`` (a device tensor or a host number) to the counter
    ``name`` while tracing is on."""
    if not _on:
        return
    if torch.is_tensor(value):
        total = _device.get(name)
        _device[name] = value.detach().clone() if total is None else total + value.detach()
    else:
        _host[name] = _host.get(name, 0) + value


def count_compact(n_valid, budget):
    """The counters ``compact.valid`` and ``compact.dropped`` (the valid
    samples past the point budget) while tracing is on: ``n_valid``, a
    device tensor of one or more compactions' valid-sample counts, each
    against ``budget``."""
    if not _on:
        return
    count("compact.valid", n_valid.sum())
    count("compact.dropped", (n_valid - budget).clamp_min(0).sum())


def host_read(value, site, convert=int):
    """``convert(value)``: the one way a device value reaches the host on
    the hot path (``int``, ``bool``, ``torch.Tensor.tolist``, ...). While
    tracing is on, the read is counted under ``site`` and timed as a
    ``host.read`` span."""
    if not _on:
        return convert(value)
    _reads[site] = _reads.get(site, 0) + 1
    with _Span("host.read", {"site": site}):
        return convert(value)


def collect():
    """What was recorded since ``enable()``: {"spans": [{name, start_ns,
    end_ns, parent, request, attrs}], "counters": {name: number}, "reads":
    {site: count}}. Reads the device counters (call it off the hot path);
    a span still open has ``end_ns`` None."""
    counters = dict(_host)
    for name, total in _device.items():
        counters[name] = counters.get(name, 0) + total.item()
    spans = [{"name": n, "start_ns": s, "end_ns": e, "parent": p, "request": r, "attrs": dict(a)}
             for n, s, e, p, r, a in _spans]
    return {"spans": spans, "counters": counters, "reads": dict(_reads)}


def write_chrome_trace(record, path):
    """Write ``collect()``'s record as a Chrome trace (JSON): each closed
    span a complete event at its unix time in µs, the profiler's clock, so
    it opens beside a ``torch.profiler`` export; the counters and reads as
    counter events at the end."""
    events = [{"name": s["name"], "ph": "X", "ts": s["start_ns"] / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "pid": "arcnerf_torch", "tid": "spans", "args": dict(s["attrs"], request=s["request"])}
              for s in record["spans"] if s["end_ns"] is not None]
    end = max((e["ts"] + e["dur"] for e in events), default=0.0)
    for name, values in (("counters", record["counters"]), ("host.reads", record["reads"])):
        events.append({"name": name, "ph": "C", "ts": end, "pid": "arcnerf_torch", "args": values})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
