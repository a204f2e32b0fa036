"""The reading of the program's spans and counters (``spans.py``, the
readers of ``METRICS``, ``spans_run.py``): device operations put down to
the span open at their launch, on synthetic events with nested spans and a
graph launch; idle gaps by span; each reader on a synthetic reading; and
the traced rehearsal of every cell through ``spans_run.py``, which reports
the host-side metrics and leaves every existing reading as ``run.py``
gives it."""

import json
import os
import subprocess
import sys

import pytest

from bench_torch import run, spans, spans_run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def span(name, start, end, parent=None, request=None, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent, "request": request, "attrs": attrs}


# a frame (0) with a chunk (1) holding the sampler (2) and the field (3), a
# host read (4); then a stride (5) whose replay (6) launches a graph
SPANS = [span("render.frame", 0, 100, None, 0), span("render.chunk", 10, 60, 0, 0),
         span("model.sample", 12, 20, 1, 0), span("model.field", 30, 50, 1, 0), span("host.read", 70, 90, 0, 0),
         span("train.stride", 200, 300, None, 5), span("train.replay", 210, 220, 5, 5)]


def test_device_operations_fall_to_the_span_open_at_their_launch():
    launches = {1: 15, 2: 40, 3: 55, 4: 65, 5: 215, 6: 150, 7: 400}
    # (correlation id, device start, end): the device runs late; three
    # kernels of one graph launch share its id; 8 has no launch
    ops = [(1, 100, 110), (2, 110, 150), (3, 150, 160), (4, 160, 165), (5, 300, 310), (5, 310, 330), (5, 330, 335),
           (6, 335, 340), (7, 500, 501), (8, 600, 610)]
    got = spans.attribute(SPANS, launches, ops)
    s = 1e-9
    assert got["own"] == pytest.approx({"model.sample": 10 * s, "model.field": 40 * s, "render.chunk": 10 * s,
                                        "render.frame": 5 * s, "train.replay": 35 * s, None: 5 * s + 1 * s + 10 * s})
    assert got["inclusive"] == pytest.approx({"model.sample": 10 * s, "model.field": 40 * s, "render.chunk": 60 * s,
                                              "render.frame": 65 * s, "train.replay": 35 * s,
                                              "train.stride": 35 * s, None: 16 * s})
    assert got["linked_share"] == pytest.approx((116 - 10) / 116)


def test_idle_gaps_fall_to_the_span_open_over_their_middle():
    ops = [(1, 0, 10), (2, 25, 40), (3, 95, 205), (4, 205, 215)]
    gaps = spans.busy_gaps(ops, 0, 320)
    assert gaps == [(10, 25), (40, 95), (215, 320)]
    idle = spans.idle_by_span(SPANS, gaps)
    # middles 17 (the sampler), 67 (the frame, between chunk and read), 267 (the stride)
    assert idle == pytest.approx({"model.sample": 15e-9, "render.frame": 55e-9, "train.stride": 105e-9})


def test_dispatch_is_the_frames_host_time_less_their_reads():
    record = {"spans": SPANS + [span("render.frame", 400, 450, None, 7), span("host.read", 410, 415, 7, 7)],
              "reads": {"render.alive": 2}, "counters": {"compact.valid": 3}}
    w = spans.window_reading(record, 2, "render.frame", 1e-6)
    assert w["dispatch_s"] == pytest.approx((100 - 20 + 50 - 5) * 1e-9)
    assert w["reads"] == {"render.alive": 2} and w["units"] == 2


def reading():
    return {"units": 4, "unit": "frame", "span_device_s": {"model.sample": 0.2, "model.compact": 0.1,
                                                           "train.occupancy": 0.004},
            "spans_window": {"units": 2, "dispatch_s": 0.19, "reads": {"a": 3, "b": 5},
                             "counters": {"compact.valid": 400, "compact.dropped": 10}}}


@pytest.mark.parametrize("name,value", [("dispatch_ms.serve", 95.0), ("host_reads.serve", 4.0),
                                        ("host_reads.train", 4.0), ("sampler_ms.serve", 50.0),
                                        ("compact_ms.serve", 25.0), ("occupancy_ms.train", 1.0),
                                        ("dropped_pct.train", 2.5)])
def test_each_reader_on_a_synthetic_reading(name, value):
    module = run.reader(name)
    assert module.read(reading()) == pytest.approx(value)
    # a reading without spans (the benchmark's own traced run) reads nothing
    assert module.read({"units": 4, "unit": "frame", "by_group": {}}) is None


def test_the_metrics_are_declared_as_benchmark_json_declares_its_own():
    moves = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in spans_run.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] in layers and set(m["workloads"]) <= set(moves[m["moves"]]["workloads"])
        assert m["name"] not in {x["name"] for x in BENCH["per_layer"]}


def rehearse(script, cell, trace, seed=4000000011):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch", script), "--workload", cell, "--seed",
                           str(seed), "--seconds", "1.5", "--trace", str(trace), "--rehearse"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          # one thread a run: the CPU's threaded sums do not repeat bit for bit, and
                          # parallel rehearsals with every core each thrash
                          env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reports_the_host_side_metrics(cell):
    plain = rehearse("run.py", cell, 1)
    traced = rehearse("spans_run.py", cell, 1)
    assert traced["correct"] is True and traced["check"] == plain["check"]
    new = {m["name"] for m in spans_run.METRICS if cell in m["workloads"]}
    assert set(traced["metrics"]) == set(plain["metrics"]) | (new & set(traced["metrics"]))
    # the CPU has no device trace: the host-side metrics read, the device ones do not
    host_side = {n for n in new if n.split(".")[0] in ("dispatch_ms", "host_reads", "dropped_pct")}
    assert host_side <= set(traced["metrics"]) and host_side
    assert traced["spans"]["spans_window"]["n_spans"] > 0


def test_untraced_rehearsal_with_spans_on():
    result = rehearse("spans_run.py", "serve_windowed_ngp_quad", 0)
    assert result["correct"] is True and "frame_ms" in result["metrics"]
    window = result["spans"]["spans_window"]
    assert window["units"] == result["attempted"] and window["dispatch_s"] > 0 and window["reads"]


def test_tracing_cost_rehearsal_alternates_off_and_on():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch", "tracing_cost.py"), "--workload",
                           "serve_exact_ngp_quad", "--seed", "3", "--blocks", "2", "--per", "1", "--rehearse"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(result["off"]) == len(result["on"]) == len(result["ratios"]) == 2
    assert result["unit"] == "ms/frame" and all(v > 0 for v in result["off"] + result["on"])
