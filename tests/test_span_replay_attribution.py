"""The benchmark's reading of CUDA graph replays through the program's layer
maps (``bench_torch/graph_spans.py``) on synthetic spans and events: a
replay's device operations land, in start order, under the span paths of
its map's nodes, below the replay span (inclusive and own); a replay whose
operation count differs from its map stays on the replay span and counts
as unmapped; eager launches, graph launches of unnamed or unmapped graphs
and unlinked operations read as ``spans.attribute`` reads them; the
profiler's events come in on the spans' clock with each launch's name.
"""

import types

import pytest
import torch

from bench_torch import graph_spans, spans

GRAPH = "train.step/0"
MAP = [["model.sample"], ["model.sample", "model.error_bound"], [], ["train.backward"]]


def _span(name, start, end, parent, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent, "request": 0, "attrs": attrs}


# a stride with a replay of GRAPH, a replay of a graph never captured, and an eager sampler call
SPANS = [_span("train.stride", 0, 10_000, None),
         _span("train.replay", 100, 200, 0, graph=GRAPH),
         _span("train.replay", 300, 400, 0, graph="train.step/9"),
         _span("model.sample", 500, 600, 0)]


def _replay(corr, t0, durations):
    """The device operations of one graph launch: back to back from t0,
    listed out of their start order."""
    ops, t = [], t0
    for d in durations:
        ops.append((corr, t, t + d))
        t += d
    return ops[::-1]


def _read(launches, device_ops, graphs=None):
    return graph_spans.attribute(SPANS, {GRAPH: MAP} if graphs is None else graphs, launches, device_ops)


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-18), k


def test_a_replays_operations_land_under_its_maps_span_paths():
    launches = {1: (150, "cudaGraphLaunch"), 2: (160, "cudaGraphLaunch")}
    ops = _replay(1, 1_000, [10, 20, 30, 40]) + _replay(2, 2_000, [1, 2, 3, 4])
    got = _read(launches, ops)
    assert got["unmapped_replays"] == 0 and got["linked_share"] == pytest.approx(1.0)
    _close(got["own"], {"model.sample": 11e-9, "model.error_bound": 22e-9, "train.replay": 33e-9,
                        "train.backward": 44e-9})
    _close(got["inclusive"], {"model.sample": 33e-9, "model.error_bound": 22e-9, "train.backward": 44e-9,
                              "train.replay": 110e-9, "train.stride": 110e-9})


def test_a_replay_whose_count_differs_from_its_map_stays_on_the_replay_span():
    launches = {1: (150, "cudaGraphLaunch"), 2: (160, "cudaGraphLaunch_v10000")}
    ops = _replay(1, 1_000, [10, 20, 30]) + _replay(2, 2_000, [1, 2, 3, 4])
    got = _read(launches, ops)
    assert got["unmapped_replays"] == 1
    _close(got["own"], {"train.replay": 63e-9, "model.sample": 1e-9, "model.error_bound": 2e-9,
                        "train.backward": 4e-9})
    _close(got["inclusive"], {"train.replay": 70e-9, "train.stride": 70e-9, "model.sample": 3e-9,
                              "model.error_bound": 2e-9, "train.backward": 4e-9})


@pytest.mark.parametrize("case", ["eager", "unmapped graph", "no graph map", "kernel launch in a replay span",
                                  "unlinked"])
def test_other_operations_read_as_spans_attribute_reads_them(case):
    launches = {1: (550, "cudaLaunchKernel"), 2: (5_000, "cudaMemsetAsync"), 3: (350, "cudaGraphLaunch"),
                4: (150, "cudaLaunchKernel"), 5: (150, "cudaGraphLaunch")}
    ops = {"eager": [(1, 1_000, 1_010), (2, 1_020, 1_050)],
           "unmapped graph": _replay(3, 1_000, [10, 20, 30, 40]),
           "no graph map": _replay(5, 1_000, [10, 20, 30, 40]),
           "kernel launch in a replay span": [(4, 1_000, 1_025)],
           "unlinked": [(7, 1_000, 1_005), (1, 1_010, 1_020)]}[case]
    got = _read(launches, ops, graphs={} if case == "no graph map" else None)
    want = spans.attribute(SPANS, {k: t for k, (t, _) in launches.items()}, ops)
    assert got["unmapped_replays"] == 0
    _close(got["inclusive"], want["inclusive"])
    _close(got["own"], want["own"])
    assert got["linked_share"] == pytest.approx(want["linked_share"])


def test_an_empty_window_reads_nothing():
    got = _read({}, [])
    assert got == {"inclusive": {}, "own": {}, "linked_share": None, "unmapped_replays": 0}


def _event(name, device, corr, start_us, end_us):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, id=corr, is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us))


def _fake_profile(events, t0_ns):
    kineto = types.SimpleNamespace(trace_start_ns=lambda: t0_ns)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=kineto), events=lambda: events)


def test_the_profilers_events_come_in_on_the_spans_clock_with_each_launchs_name():
    events = [_event("bench.window", False, 0, 0.0, 10.0), _event("cudaGraphLaunch", False, 1, 0.15, 0.16),
              _event("aten::add", False, 2, 0.3, 0.4), _event("k0", True, 1, 1.0, 1.01),
              _event("k1", True, 1, 1.01, 1.03)]
    launches, device, window = graph_spans.profiled_events(_fake_profile(events, 0), "bench.window")
    assert launches == {1: (150, "cudaGraphLaunch")}
    assert device == [(1, 1_000, 1_010), (1, 1_010, 1_030)] and window == (0, 10_000)
    record = {"spans": SPANS, "graphs": {GRAPH: MAP[:2]}}
    out = graph_spans.read_profiled(_fake_profile(events, 0), record, "bench.window")
    assert out["span_unmapped_replays"] == 0 and out["span_linked_share"] == pytest.approx(1.0)
    _close(out["span_device_s"], {"model.sample": 30e-9, "model.error_bound": 20e-9, "train.replay": 30e-9,
                                  "train.stride": 30e-9})
    _close(out["span_own_s"], {"model.sample": 10e-9, "model.error_bound": 20e-9})
    assert out["span_idle_in_span"] == pytest.approx(1.0)
