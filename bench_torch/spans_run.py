"""``run.py`` with the program's own tracing on (``arcnerf_torch.utils.profiler``):
the measurement of its spans and counters, and of what tracing costs.

    python3 bench_torch/spans_run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--rehearse]

``--trace 1``: ``run.py``'s traced run, with spans on in its profiled
window, whose reading gains each device operation put down to the program
span that launched it and each idle gap to the span open over it
(``spans.py``); and a second window of the same size (``trace_frames``
frames or ``trace_strides`` strides) with spans on and the profiler off:
in serving before the profiled one, in training after it. The result line adds the per-layer metrics of
``METRICS`` (readers in ``metrics/``) and ``spans``: the span readings.

``--trace 0``: ``run.py``'s untraced window with spans on and the profiler
off. Its end-to-end metrics against ``run.py --trace 0``'s are the cost of
tracing; the result line adds ``spans``: the window's spans read as the
spans-only window is (``spans_window``).

Nothing here changes what ``run.py`` measures: it wraps the drivers and
the profiled window from outside and reads the result line ``run.py``
prints.
"""

import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from bench_torch import run, spans, trace  # noqa: E402
from bench_torch.drivers import serve, train  # noqa: E402

SERVE = ["serve_exact_ngp_quad", "serve_windowed_ngp_quad"]
TRAIN = ["train_ngp_quad", "train_ngp_xor"]


def _metric(name, unit, source, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer, "moves": moves,
            "workloads": cells}


# the metrics the spans and counters give, declared as BENCHMARK.json declares its own
METRICS = [
    _metric("dispatch_ms.serve", "ms/frame", "program_span", "render engine (RenderEngine tiers), the device",
            "frame_ms", SERVE),
    _metric("host_reads.serve", "reads/frame", "program_counter", "render engine (RenderEngine tiers), the device",
            "frame_ms", SERVE),
    _metric("host_reads.train", "reads/step", "program_counter",
            "trainer and step graph (train_steps, StepGraph), the device", "train_rays_per_s", TRAIN),
    _metric("sampler_ms.serve", "ms/frame", "program_span", "plain ops (sampler, compaction, dense march)",
            "frame_ms", SERVE),
    _metric("compact_ms.serve", "ms/frame", "program_span", "plain ops (sampler, compaction, dense march)",
            "frame_ms", SERVE[:1]),
    _metric("occupancy_ms.train", "ms/step", "program_span", "plain ops (sampler, compaction, dense march)",
            "train_rays_per_s", TRAIN),
    _metric("dropped_pct.train", "%", "program_counter", "plain ops (sampler, compaction, dense march)",
            "train_rays_per_s", TRAIN),
]


# the traced run's reading, for the result line
_READINGS = []
SPAN_KEYS = ("units", "unit", "span_device_s", "span_own_s", "span_linked_share", "span_idle_s", "span_idle_in_span",
             "spans_window")


def _window_with_spans(driver, seconds):
    """The driver's window with spans on; its spans read as a spans-only
    window of the frames or steps it completed."""
    with _tracing() as record:
        t0 = driver.ctx.clock()
        e2e, units, failed = super(type(driver), driver).window(seconds)
        wall = driver.ctx.clock() - t0
    _READINGS.append({"spans_window": spans.window_reading(record(), units, driver.top, wall)})
    return e2e, units, failed


class SpansServing(serve.DRIVER):
    top = "render.frame"

    def window(self, seconds):
        return _window_with_spans(self, seconds)

    def traced(self, reading):
        # the spans-only frames first: after torch.profiler the process
        # serves frames ~37 % slower, and dispatch_ms reads host time; a
        # frame changes no state, so the profiled frames are the same
        n = int(self.ctx.workload["traffic"]["trace_frames"])
        with _tracing() as record:
            t0 = self.ctx.clock()
            for i in range(n):
                self.frame(i)
                self.ctx.sync()
            wall = self.ctx.clock() - t0
        spans_window = spans.window_reading(record(), n, self.top, wall)
        out = super().traced(reading)
        reading["spans_window"] = spans_window
        _READINGS.append(reading)
        return out


class SpansTraining(train.DRIVER):
    top = "train.stride"

    def window(self, seconds):
        return _window_with_spans(self, seconds)

    def traced(self, reading):
        # the spans-only strides after the profiled ones, which would
        # otherwise start from another state; their metrics are counts,
        # which the profiler does not move
        out = super().traced(reading)
        steps = 0
        with _tracing() as record:
            t0 = self.ctx.clock()
            for _ in range(int(self.ctx.workload["traffic"]["trace_strides"])):
                steps += self.stride()[0]
            self.ctx.sync()
            wall = self.ctx.clock() - t0
        reading["spans_window"] = spans.window_reading(record(), steps, self.top, wall)
        _READINGS.append(reading)
        return out


@contextlib.contextmanager
def _tracing():
    """Spans on inside the block; yields the function that collects them."""
    profiler = spans.door()
    profiler.enable()
    try:
        yield profiler.collect
    finally:
        profiler.disable()


def _profiled_with_spans(profiled):
    @contextlib.contextmanager
    def wrapped(sink):
        with _tracing():
            with profiled(sink):
                yield

    return wrapped


def _read_with_spans(read):
    def wrapped(prof, wall):
        r = read(prof, wall)
        r.update(spans.read_profiled(prof, spans.door().collect(), trace.WINDOW))
        return r

    return wrapped


def _load_cell_with_metrics(load_cell):
    def wrapped(name, rehearse=False):
        bench, cell, config, workload = load_cell(name, rehearse)
        bench = dict(bench, per_layer=bench["per_layer"] + METRICS)
        return bench, cell, config, workload

    return wrapped


def main(argv=None, out=None):
    out = out or sys.stdout
    argv = list(sys.argv[1:] if argv is None else argv)
    serve.DRIVER, train.DRIVER = SpansServing, SpansTraining
    run.load_cell = _load_cell_with_metrics(run.load_cell)
    trace.profiled = _profiled_with_spans(trace.profiled)
    trace.read = _read_with_spans(trace.read)
    line = io.StringIO()
    rc = run.main(argv, out=line)
    if rc != 0:
        return rc
    result = json.loads(line.getvalue().strip().splitlines()[-1])
    result["spans"] = {k: _READINGS[-1][k] for k in SPAN_KEYS if k in _READINGS[-1]}
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
