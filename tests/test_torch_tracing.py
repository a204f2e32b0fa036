"""The port's spans and counters (``arcnerf_torch.utils.profiler``) on the
CPU, over an exact and a windowed frame of the small model and three
strides of the small training run:

- tracing off records nothing, enters no profiler annotation, adds no
  host read (``Tensor.item``, ``__int__``, ``__bool__``, ``tolist`` and
  ``cpu`` counted) and no device operation (the dispatched operations
  equal those of a program whose tracing calls do nothing); the captured
  training step dispatches the same operations with tracing on or off;
- tracing on changes no image, loss or parameter bit and adds no host
  read; spans nest with the right parents and requests, and a span lines
  up with the profiler's annotation of the same name;
- ``host_read`` counts by site; ``compact.dropped`` counts the valid
  samples past the point budget;
- a graph's capture maps each device node to the spans open on the
  capturing thread when it was made (a counter of nodes stands in for the
  card's graph), tracing off, on or suspended; ``collect()`` returns the
  maps of the graphs its replay spans name; a step records its draw,
  forward, loss, backward and optimizer spans.
"""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
from arcnerf_torch.models import build_model
from arcnerf_torch.render.engine import RenderEngine
from arcnerf_torch.trainer import ArcNerfTrainer
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from tests.test_torch_slice import CFG, SMALL, view_rays
from tests.test_torch_step_graph import STRIDED

torch.set_num_threads(1)
WH, CHUNK, CAP = 24, 64, 8
WHITE = (1.0, 1.0, 1.0)
READS = ("item", "__int__", "__bool__", "tolist", "cpu")
CASES = ("exact", "windowed", "strides")


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    yield
    profiler.disable()


def engine():
    cfgs = update_configs_by_dotlist(load_configs(CFG), list(SMALL))
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0))
    bound_state = model.init_bound_state()
    bound_state["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(16, 2.0))
    return RenderEngine(model, cfgs, bound_state, "cpu")


def sample():
    ro, rd = view_rays(WH)
    return {"rays_o": ro, "rays_d": rd, "H": WH, "W": WH}


def trainer(tmp_path, name):
    cfgs = update_configs_by_dotlist(load_configs(CFG), STRIDED + [
        "--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps", "4"])
    return ArcNerfTrainer(cfgs)


def run_case(case, tmp_path, name):
    """The case's work -> its outputs (images; or losses, parameters and
    the bitfield)."""
    if case == "strides":
        t = trainer(tmp_path, name)
        for epoch in (0, 4, 8):
            t.pipeline.update_dynamic_bs(epoch, t.log_max_allowance)
            stats = t.train_steps(epoch, 4)
        t._warn_budget_overflow(stats)
        t.valid_epoch(12)
        out = {"loss": torch.stack(t.loss_history), "bitfield": t.bound_state["fg"]["bitfield"]}
        out.update({k: p.detach() for k, p in t.model.named_parameters()})
        return out
    e = engine()
    if case == "exact":
        e.set_render_cap(CAP)
        return e.render_image(sample(), chunk_rays=CHUNK, bkg_color=WHITE)
    e.set_render_cap(CAP, window=True)
    imgs, stats = e.render_image_windowed(sample(), n_pass=4, chunk_rays=CHUNK, bkg_color=WHITE)
    assert stats["alive_per_pass"][0] > 0  # a pass after the first renders
    return imgs


@contextlib.contextmanager
def counted_reads():
    """Count every call of the Tensor methods that read a value to the host."""
    counts = {k: 0 for k in READS}
    saved = {k: getattr(torch.Tensor, k) for k in READS}
    own = {k for k in READS if k in vars(torch.Tensor)}

    def counting(k):
        def read(self, *args, **kwargs):
            counts[k] += 1
            return saved[k](self, *args, **kwargs)
        return read

    for k in READS:
        setattr(torch.Tensor, k, counting(k))
    try:
        yield counts
    finally:
        for k, f in saved.items():
            if k in own:
                setattr(torch.Tensor, k, f)
            else:
                delattr(torch.Tensor, k)


class OpLog(TorchDispatchMode):
    """The names of the dispatched operations, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case off and on: outputs, reads counted, and the record."""
    tmp = tmp_path_factory.mktemp("tracing")
    out = {}
    for case in CASES:
        profiler.disable()
        with counted_reads() as reads_off:
            off = run_case(case, tmp, case + "_off")
        profiler.enable()
        with counted_reads() as reads_on:
            on = run_case(case, tmp, case + "_on")
        profiler.disable()
        out[case] = {"off": off, "on": on, "reads_off": dict(reads_off), "reads_on": dict(reads_on),
                     "record": profiler.collect()}
    return out


# -------------------------------------------------------------- tracing off
@pytest.mark.parametrize("case", CASES)
def test_tracing_off_records_nothing(case, tmp_path):
    profiler.enable()
    profiler.disable()
    run_case(case, tmp_path, "off")
    assert profiler.collect() == {"spans": [], "counters": {}, "reads": {}, "graphs": {}}


@pytest.mark.parametrize("case", ["exact", "windowed"])
def test_tracing_off_enters_no_profiler_annotation(case, tmp_path):
    names = {"render.frame", "render.chunk", "render.pass", "render.prepass", "render.assemble", "model.sample",
             "model.compact", "model.field", "model.march", "host.read"}
    for on in (False, True):
        if on:
            profiler.enable()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run_case(case, tmp_path, "annotated")
        profiler.disable()
        seen = {ev.name for ev in prof.events()} & names
        if on:
            assert {"render.frame", "render.chunk", "model.sample", "model.field"} <= seen
        else:
            assert not seen


@pytest.mark.parametrize("case", CASES)
def test_tracing_adds_no_host_read(runs, case):
    r = runs[case]
    assert r["reads_on"] == r["reads_off"]
    assert sum(r["reads_off"].values()) > 0 or case == "exact"


def _stub_profiler(monkeypatch):
    monkeypatch.setattr(profiler, "span", lambda name, **attrs: contextlib.nullcontext())
    monkeypatch.setattr(profiler, "count", lambda name, value: None)
    monkeypatch.setattr(profiler, "host_read", lambda value, site, convert=int: convert(value))
    monkeypatch.setattr(profiler, "active", lambda: False)


@pytest.mark.parametrize("case", ["exact", "windowed"])
def test_tracing_off_adds_no_device_operation(case, tmp_path, monkeypatch):
    with OpLog() as off:
        run_case(case, tmp_path, "ops_off")
    _stub_profiler(monkeypatch)
    with OpLog() as bare:
        run_case(case, tmp_path, "ops_bare")
    assert off.ops == bare.ops and len(off.ops) > 100


def test_the_captured_step_is_the_same_with_tracing_on_or_off(tmp_path):
    logs = []
    for on in (False, True):
        t = trainer(tmp_path, "captured_{}".format(on))  # the same state each time
        t.train_steps(0, 4)
        graph = t.step_graphs[(t.pipeline.n_rays, None)]
        graph.slot.zero_()
        if on:
            profiler.enable()
        with OpLog() as log:
            graph._step()  # what a CUDA graph captures
        profiler.disable()
        logs.append(log.ops)
    assert logs[0] == logs[1] and len(logs[0]) > 100
    names = [s["name"] for s in profiler.collect()["spans"]]
    assert {"model.sample", "model.compact", "model.field", "model.march"} <= set(names)
    assert profiler.collect()["counters"] == {}  # nothing counted inside the step


# --------------------------------------------------------------- tracing on
@pytest.mark.parametrize("case", CASES)
def test_outputs_are_bit_identical_with_tracing_on_and_off(runs, case):
    off, on = runs[case]["off"], runs[case]["on"]
    assert sorted(off) == sorted(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def _ancestors(spans, i):
    out = []
    while spans[i]["parent"] is not None:
        i = spans[i]["parent"]
        out.append(spans[i]["name"])
    return out


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_with_their_parents_and_requests(runs, case):
    spans = runs[case]["record"]["spans"]
    assert spans and all(s["end_ns"] is not None for s in spans)
    for i, s in enumerate(spans):
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is None:
            assert s["request"] == i
        else:
            p = spans[s["parent"]]
            assert s["parent"] < i and p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
            assert s["request"] == p["request"]
    names = {s["name"] for s in spans}
    tops = {s["name"] for s in spans if s["parent"] is None}
    if case == "strides":
        # the budget check reads at the log cadence, between strides
        assert tops == {"train.stride", "train.batch_size", "train.validate", "host.read"}
        assert {"train.occupancy", "model.field"} <= names
        for i, s in enumerate(spans):
            if s["name"] == "model.field" and "train.occupancy" in _ancestors(spans, i):
                break
        else:
            raise AssertionError("no model.field under train.occupancy")
        strides = [s for s in spans if s["name"] == "train.stride"]
        assert [(s["attrs"]["epoch"], s["attrs"]["steps"]) for s in strides] == [(0, 4), (4, 4), (8, 4)]
    else:
        assert tops == {"render.frame"}
        assert {s["attrs"]["tier"] for s in spans if s["name"] == "render.frame"} == {case}
        for i, s in enumerate(spans):
            if s["name"] in ("model.sample", "model.compact", "model.field", "model.march"):
                assert "render.chunk" in _ancestors(spans, i)
            if s["name"] == "render.chunk":
                assert _ancestors(spans, i)[-1] == "render.frame"
        if case == "windowed":
            assert {"render.prepass", "render.pass", "host.read"} <= names
            passes = [s["attrs"]["p"] for s in spans if s["name"] == "render.pass"]
            assert passes[:2] == [0, 1] and passes == sorted(passes)


@pytest.mark.parametrize("case", CASES)
def test_counters_and_reads(runs, case):
    rec = runs[case]["record"]
    counters, reads = rec["counters"], rec["reads"]
    n_reads = sum(1 for s in rec["spans"] if s["name"] == "host.read")
    assert n_reads == sum(reads.values())
    if case == "exact":
        assert reads == {} and sum(s["name"] == "render.chunk" for s in rec["spans"]) == -(-WH * WH // CHUNK)
        assert counters["compact.valid"] > 0 and counters["compact.dropped"] == 0
    elif case == "windowed":
        passes = sum(1 for s in rec["spans"] if s["name"] == "render.pass")
        assert reads == {"render.ladder": 1, "render.hit_count": 1, "render.alive": passes - 1,
                         "render.alive_end": 1, "render.background": 1}
        # each chunk of every window samples through the fused sampler's window mode
        chunks = sum(1 for s in rec["spans"] if s["name"] == "render.chunk")
        assert set(counters) == {"compact.valid", "compact.dropped", "sample.window"}
        assert counters["sample.window"] == chunks > 0
    else:
        assert set(reads) == {"train.batch_size", "train.budget_check", "train.validate"}
        assert reads["train.batch_size"] == 2  # at epochs 4 and 8
        assert counters["compact.valid"] > 0 and 0 <= counters["compact.dropped"] <= counters["compact.valid"]


def test_spans_nest_parents_and_requests_by_hand():
    profiler.enable()
    with profiler.span("a"):
        with profiler.span("b", k=1):
            with profiler.span("c"):
                pass
        with profiler.span("d"):
            pass
    with profiler.span("e"):
        pass
    spans = profiler.collect()["spans"]
    assert [s["name"] for s in spans] == list("abcde")
    assert [s["parent"] for s in spans] == [None, 0, 1, 0, None]
    assert [s["request"] for s in spans] == [0, 0, 0, 0, 4]
    assert spans[1]["attrs"] == {"k": 1}


def test_a_span_lines_up_with_the_profiler_annotation(tmp_path):
    e, s = engine(), sample()
    e.set_render_cap(CAP)
    e.render_image(s, chunk_rays=CHUNK)  # warm
    profiler.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        e.render_image(s, chunk_rays=CHUNK)
        e.render_image(s, chunk_rays=CHUNK)
    profiler.disable()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for name in ("render.frame", "render.chunk", "model.field"):
        spans = [x for x in profiler.collect()["spans"] if x["name"] == name]
        events = sorted((ev for ev in prof.events() if ev.name == name), key=lambda ev: ev.time_range.start)
        assert len(spans) == len(events) > 0
        for sp, ev in zip(spans, events):
            assert abs((sp["start_ns"] - t0) / 1e3 - ev.time_range.start) < 50.0, name
            assert abs((sp["end_ns"] - t0) / 1e3 - ev.time_range.end) < 50.0, name


# ------------------------------------------------------- reads and counters
def test_host_read_counts_by_site():
    value = torch.tensor([3, 4])
    assert profiler.host_read(value.sum(), "a") == 7  # off: the read alone
    assert profiler.collect()["reads"] == {}
    profiler.enable()
    assert profiler.host_read(value.sum(), "a") == 7
    assert profiler.host_read(value, "b", torch.Tensor.tolist) == [3, 4]
    assert profiler.host_read(value.any(), "b", bool) is True
    rec = profiler.collect()
    assert rec["reads"] == {"a": 1, "b": 2}
    assert [(s["name"], s["attrs"]["site"]) for s in rec["spans"]] == [("host.read", "a"), ("host.read", "b"),
                                                                        ("host.read", "b")]


def test_count_sums_device_and_host_values():
    profiler.count("x", 1)  # off
    profiler.enable()
    profiler.count("x", 2)
    profiler.count("x", torch.tensor(5))
    profiler.count("x", torch.tensor(7))
    profiler.count("y", 3)
    assert profiler.collect()["counters"] == {"x": 14, "y": 3}


@pytest.mark.parametrize("n_valid", [3000, 4096, 5000])  # the point budget is 2^12
def test_compact_dropped_counts_the_samples_past_the_budget(n_valid):
    e = engine()
    fg = e.model.fg_model
    n_rays, n_pts = 128, 64
    budget = fg._compact_budget(n_rays, True)
    assert budget == 4096 < n_rays * n_pts
    rng = np.random.default_rng(n_valid)
    flat = np.zeros(n_rays * n_pts, bool)
    flat[rng.choice(n_rays * n_pts, n_valid, replace=False)] = True
    mask = torch.from_numpy(flat.reshape(n_rays, n_pts))
    rays_o = torch.zeros(n_rays, 3)
    rays_d = torch.nn.functional.normalize(torch.ones(n_rays, 3), dim=-1)
    zvals = torch.linspace(0.1, 2.0, n_pts).expand(n_rays, n_pts).contiguous()
    geo_net, radiance_net = fg.get_net()
    profiler.enable()
    with torch.inference_mode():
        fg.fused_render_by_mask_pts(geo_net, radiance_net, rays_o, rays_d, zvals, mask, inference_only=True)
    counters = profiler.collect()["counters"]
    assert counters == {"compact.valid": n_valid, "compact.dropped": max(0, n_valid - budget)}


def test_training_counts_its_dropped_samples_from_the_steps(tmp_path):
    t = trainer(tmp_path, "dropped")
    # a budget of 2 samples, under every step's count, so that the steps' samples past it count as dropped
    t.log_max_allowance = 1
    budget = 1 << t.log_max_allowance
    profiler.enable()
    t.train_steps(0, 4)
    counts = torch.stack([m[0] for m in t.pipeline._measured])
    assert len(counts) == 4 and int((counts - budget).clamp_min(0).sum()) > 0
    # and the fused sampler's steps: counted with them, outside the step
    assert profiler.collect()["counters"] == {"compact.valid": int(counts.sum()),
                                              "compact.dropped": int((counts - budget).clamp_min(0).sum()),
                                              "sample.fused": 4}


def test_count_compact_drops_what_passes_the_budget():
    profiler.count_compact(torch.tensor([7, 9]), 8)  # off: nothing
    profiler.enable()
    profiler.count_compact(torch.tensor([3, 8, 12, 9]), 8)
    profiler.count_compact(torch.tensor(10), 8)
    assert profiler.collect()["counters"] == {"compact.valid": 42, "compact.dropped": 7}


def test_write_chrome_trace(tmp_path):
    profiler.enable()
    with profiler.span("render.frame", tier="exact"):
        profiler.host_read(torch.tensor(2), "s")
    profiler.count("compact.valid", 4)
    profiler.disable()
    path = tmp_path / "trace.json"
    profiler.write_chrome_trace(profiler.collect(), str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [ev for ev in events if ev["ph"] == "X"]
    assert [ev["name"] for ev in spans] == ["render.frame", "host.read"]
    assert spans[0]["ts"] <= spans[1]["ts"] and spans[0]["args"] == {"tier": "exact", "request": 0}
    assert {ev["name"]: ev["args"] for ev in events if ev["ph"] == "C"} == {"counters": {"compact.valid": 4},
                                                                            "host.reads": {"s": 1}}


def test_inference_writes_its_spans_as_a_chrome_trace(tmp_path, monkeypatch):
    import sys

    from arcnerf_torch import inference
    from tests.test_torch_inference import inference_argv, seeded_checkpoint

    monkeypatch.setitem(sys.modules, "cv2", None)  # PNG frames
    seeded_checkpoint(tmp_path / "ngp.pt")
    path = tmp_path / "trace.json"
    inference.main(inference_argv(tmp_path / "ngp.pt", tmp_path / "out", n_cam=2) + ["--trace", str(path)])
    assert not profiler.active()
    events = json.loads(path.read_text())["traceEvents"]
    frames = [ev for ev in events if ev["name"] == "render.frame"]
    assert len(frames) == 2 and all(ev["args"]["tier"] == "exact" for ev in frames)
    assert {ev["name"] for ev in events} >= {"render.chunk", "model.sample", "model.field", "counters"}


# ------------------------------------------------------- capture layer maps
class FakeNodes:
    """A capture's nodes without a card: ``make`` adds nodes by kind; the
    kernels, memcpys and memsets are the device nodes."""

    DEVICE = ("kernel", "memcpy", "memset")

    def __init__(self):
        self.kinds = []

    def make(self, *kinds):
        self.kinds.extend(kinds)

    def count(self):
        return len(self.kinds)

    def device_nodes(self):
        return [i for i, k in enumerate(self.kinds) if k in self.DEVICE]


def _capture_work(nodes):
    """Nodes made outside, inside and between nested spans, and nodes no
    trace shows (an event, a host node)."""
    nodes.make("kernel")
    with profiler.span("a"):
        nodes.make("kernel", "event")
        with profiler.span("b", k=1):
            nodes.make("memset", "kernel")
        nodes.make("memcpy")
        with profiler.span("c"):
            pass
    nodes.make("host", "kernel")


CAPTURE_MAP = [[], ["a"], ["a", "b"], ["a", "b"], ["a"], []]


def _maps_named(*graphs):
    """``collect()["graphs"]`` after a replay span naming each graph."""
    profiler.enable()
    for graph in graphs:
        with profiler.span("train.replay", graph=graph):
            pass
    return profiler.collect()["graphs"]


@pytest.mark.parametrize("mode", ["off", "on", "suspended"])
def test_a_capture_maps_each_device_node_to_the_spans_open_at_its_making(mode):
    nodes = FakeNodes()
    profiler.enable()  # a fresh record
    if mode == "off":
        profiler.disable()
    with profiler.suspended() if mode == "suspended" else contextlib.nullcontext():
        with profiler.capturing("test.graph", nodes) as capture:
            _capture_work(nodes)
    spans = profiler.collect()["spans"]
    assert [s["name"] for s in spans] == (["a", "b", "c"] if mode == "on" else [])
    assert capture.graph.startswith("test.graph/") and capture.seconds > 0
    assert _maps_named(capture.graph) == {capture.graph: CAPTURE_MAP}


def test_each_capture_takes_a_graph_id_of_its_own():
    ids = []
    for _ in range(3):
        with profiler.capturing("test.graph", FakeNodes()) as capture:
            pass
        ids.append(capture.graph)
    assert len(set(ids)) == 3 and all(i.startswith("test.graph/") for i in ids)


def test_an_off_span_outside_a_capture_is_the_shared_no_op():
    off = profiler.span("x")
    assert profiler.span("y", k=1) is off and not profiler.active()
    seen = []
    with profiler.capturing("test.graph", FakeNodes()):
        assert profiler.span("x") is not off
        worker = threading.Thread(target=lambda: seen.append(profiler.span("x")))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    assert seen == [off] and profiler.span("x") is off


def test_a_capture_ignores_the_spans_of_other_threads():
    # autograd runs a graph's backward on threads of its own: their spans
    # record nothing, and the nodes they make take the capturing thread's path
    nodes = FakeNodes()

    def autograd_thread():
        with profiler.span("other"):
            nodes.make("kernel")

    with profiler.capturing("test.graph", nodes) as capture:
        with profiler.span("a"):
            worker = threading.Thread(target=autograd_thread)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            nodes.make("kernel")
        nodes.make("kernel")
    assert _maps_named(capture.graph) == {capture.graph: [["a"], ["a"], []]}


def test_a_failed_capture_keeps_no_map_and_captures_do_not_nest():
    nodes = FakeNodes()
    with pytest.raises(ValueError):
        with profiler.capturing("test.graph", nodes) as failed:
            with pytest.raises(RuntimeError, match="already capturing"):
                with profiler.capturing("test.other", nodes):
                    pass
            with profiler.span("a"):
                nodes.make("kernel")
                raise ValueError("the capture failed")
    assert profiler.span("x") is profiler.span("y")  # the capture mode ended
    assert _maps_named(failed.graph) == {}


def test_collect_returns_the_maps_of_the_graphs_its_replays_name():
    first, second = FakeNodes(), FakeNodes()
    with profiler.capturing("test.first", first) as a:
        first.make("kernel")
    with profiler.capturing("test.second", second) as b:
        with profiler.span("x"):
            second.make("kernel")
    profiler.enable()  # a map outlives the record it was captured before
    assert profiler.collect()["graphs"] == {}
    maps = _maps_named(b.graph, b.graph, "never.captured/0")
    assert maps == {b.graph: [["x"]]} and a.graph not in maps
    assert json.loads(json.dumps(maps)) == maps


STEP_SPANS = ("train.draw", "train.forward", "train.loss", "train.backward", "train.optimizer")


def test_a_step_records_its_layer_spans(runs):
    # each of the three strides' four steps: the batch's draw, the model's
    # forward, the loss, its backward, then the rate, Adam and the EMA,
    # directly under the stride
    spans = runs["strides"]["record"]["spans"]
    for name in STEP_SPANS:
        mine = [i for i, s in enumerate(spans) if s["name"] == name]
        assert len(mine) == 12, name
        assert all(spans[spans[i]["parent"]]["name"] == "train.stride" for i in mine)
    assert [s["name"] for s in spans if s["name"] in STEP_SPANS] == list(STEP_SPANS) * 12
