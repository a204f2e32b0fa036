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
``train.replay``, ``render.replay``, ...). The captured training step
calls ``span`` but never ``count``: a span has no device operation, so a
CUDA graph replays the same kernels with tracing on or off. The exact
tier's frame graphs capture with tracing ``suspended`` and count each
replay outside the graph.

A replay runs no Python, so no span opens inside it. Instead each graph is
mapped once, as it is captured (``capturing``), tracing on or off and
inside ``suspended`` too: every span the capturing thread enters records
the graph's node count at its enter and exit, and at the capture's end the
graph's device nodes (kernels, memcpys, memsets, in the order the capture
made them, which is their order on the capture's one stream) each take the
path of the spans open when the node was made. The replay spans name their
graph (``graph``), and ``collect()`` returns those graphs' maps, so a trace
can put the k-th device operation of a replay under the k-th node's spans.
Outside a capture an off ``span`` stays one flag check.
"""

import bisect
import contextlib
import itertools
import json
import threading
import time

import torch

from ..ops import cuda_lib

_on = False
_capture = None  # the _Capture recording a graph's layer map, if any
_live = False  # _on or a capture: the one flag an off span() reads
_graphs = {}  # graph id -> (the span path of each device node), every graph captured in the process
_graph_ids = itertools.count()
_spans = []  # [name, start_ns, end_ns, parent index, request index, attrs]
_open = []  # indices of the open spans, innermost last
_host = {}  # counter -> host sum
_device = {}  # counter -> device tensor sum
_reads = {}  # site -> reads
_OFF = contextlib.nullcontext()


def _refresh():
    global _live
    _live = _on or _capture is not None


def enable():
    """Start a fresh record and turn tracing on. The graphs' layer maps
    stay: they are recorded at capture, tracing on or off."""
    global _on
    _spans.clear()
    _open.clear()
    _host.clear()
    _device.clear()
    _reads.clear()
    _on = True
    _refresh()


def disable():
    """Turn tracing off; the record stays for ``collect()``."""
    global _on
    _on = False
    _refresh()


def active():
    """Whether tracing is on: callers test it before they compute a device
    value only a counter would use."""
    return _on


@contextlib.contextmanager
def suspended():
    """Tracing off inside the block and as it was after it: a CUDA graph's
    warm-up and capture record and count nothing (a counter's device sum
    would be captured, not counted); its replays count."""
    global _on
    was, _on = _on, False
    _refresh()
    try:
        yield
    finally:
        _on = was
        _refresh()


class CaptureNodes:
    """The nodes of the CUDA graph that the current stream of ``device``
    (a CUDA torch.device) is capturing, read through the kernels' binding:
    ``count()``, how many the capture has made; ``device_nodes()``, the
    positions of those a device trace shows (kernels, memcpys, memsets)."""

    def __init__(self, device):
        cuda_lib.ops()  # built and loaded before the capture
        self.device = torch.cuda.current_device() if device.index is None else device.index

    def count(self):
        return cuda_lib.ops().capture_node_count(self.device)

    def device_nodes(self):
        return cuda_lib.ops().capture_device_nodes(self.device)


class _Capture:
    """One graph's layer map as its capture records it: the path of spans
    open on the capturing thread from each node count on."""

    __slots__ = ("graph", "nodes", "thread", "path", "marks", "seconds")

    def __init__(self, graph, nodes):
        self.graph, self.nodes = graph, nodes
        self.thread = threading.get_ident()
        self.path = ()  # the open spans' names, outermost first
        self.marks = [(0, ())]  # (node count, the path of the nodes made from there on)
        self.seconds = 0.0  # the map's own cost

    def move(self, path):
        t0 = time.perf_counter()
        self.marks.append((self.nodes.count(), path))
        self.path = path
        self.seconds += time.perf_counter() - t0

    def layer_map(self):
        """Each device node's span path, in the capture's order."""
        t0 = time.perf_counter()
        counts = [n for n, _ in self.marks]
        out = tuple(self.marks[bisect.bisect_right(counts, i) - 1][1] for i in self.nodes.device_nodes())
        self.seconds += time.perf_counter() - t0
        return out


@contextlib.contextmanager
def capturing(label, nodes):
    """Record the layer map of the graph captured inside the block (enter
    it inside ``torch.cuda.graph``, on the capturing thread): ``nodes`` is
    the capture's ``CaptureNodes``. Yields the capture, whose ``graph`` is
    the graph's id (``label``/n, one n a process) and ``seconds`` what the
    map cost; the map is kept only if the block completes."""
    global _capture
    if _capture is not None:
        raise RuntimeError("graph {} is already capturing".format(_capture.graph))
    capture = _Capture("{}/{}".format(label, next(_graph_ids)), nodes)
    _capture = capture
    _refresh()
    try:
        yield capture
        _graphs[capture.graph] = capture.layer_map()
    finally:
        _capture = None
        _refresh()


class _Span:
    __slots__ = ("name", "attrs", "index", "annotation", "capture", "outer")

    def __init__(self, name, attrs, capture=None):
        self.name, self.attrs, self.capture = name, attrs, capture
        self.index = self.annotation = None

    def __enter__(self):
        if self.capture is not None:
            self.outer = self.capture.path
            self.capture.move(self.outer + (self.name,))
        if not _on:
            return self
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
        if self.index is not None:
            _spans[self.index][2] = time.time_ns()
            _open.pop()
            if self.annotation is not None:
                self.annotation.__exit__(*exc)
        if self.capture is not None:
            self.capture.move(self.outer)
        return False


def span(name, **attrs):
    """A context manager: the named span while tracing is on or the calling
    thread captures a graph, else a no-op."""
    if not _live:
        return _OFF
    capture = _capture if _capture is not None and _capture.thread == threading.get_ident() else None
    return _Span(name, attrs, capture) if _on or capture is not None else _OFF


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
    {site: count}, "graphs": {graph id: [[span name, ...] outermost first,
    a list a device node]}}, the graphs those of the spans' ``graph``
    attributes (the replays'). Reads the device counters (call it off the
    hot path); a span still open has ``end_ns`` None."""
    counters = dict(_host)
    for name, total in _device.items():
        counters[name] = counters.get(name, 0) + total.item()
    spans = [{"name": n, "start_ns": s, "end_ns": e, "parent": p, "request": r, "attrs": dict(a)}
             for n, s, e, p, r, a in _spans]
    named = {a["graph"] for *_, a in _spans if a.get("graph") in _graphs}
    graphs = {g: [list(path) for path in _graphs[g]] for g in sorted(named)}
    return {"spans": spans, "counters": counters, "reads": dict(_reads), "graphs": graphs}


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
