"""The exact tier's chunk loop and its frame graphs
(``render.frame_graph.FrameGraph``: static buffers, one CUDA graph a frame
shape, on the card alone), on the CPU at a small size with seeded weights
and the spheres' occupancy, NGP and NeuS-NGP: the loop's preallocated
frame rows against the per-chunk loop it replaced (each chunk's model call,
its outputs concatenated), every output and the valid-sample count bit for
bit, a multiple of the chunk, a tail and less than one chunk, with and
without a fed background; the counters of both. The engine's cache of
frame graphs through a stand-in that runs the loop on the graph's buffers
uncaptured (``_LoopGraph``): what drops the cached graphs and what keeps
them, which tiers and callers never use them, and ``render.eager``. No
JAX: the per-chunk loop is the reference."""

import os

import pytest
import torch

from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
from arcnerf_torch.models import build_model
from arcnerf_torch.models.base_modules import encoding, sample_compact
from arcnerf_torch.render import engine as engine_module
from arcnerf_torch.render import frame_graph
from arcnerf_torch.render.engine import RenderEngine
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 64 ladder slots over a 32^3 grid, a budget of 2^12: 64 rays x cap 8 never clip
SMALL = {"ngp": ("configs/expr/synthetic_ngp.yaml",
                 ["--model.geometry.encoder.hashmap_size", "12", "--model.obj_bound.volume.n_grid", "32",
                  "--model.rays.n_sample", "64", "--model.obj_bound.log_max_allowance", "12"]),
         "neus": ("configs/expr/synthetic_neus_ngp.yaml",
                  ["--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
                   "--model.obj_bound.volume.n_grid", "32", "--model.rays.n_sample", "64",
                   "--model.obj_bound.log_max_allowance", "12"])}
WH, CAP = 20, 8  # 400 rays
# chunk rays: 400 = 5 x 80 (a multiple), 3 x 128 + 16 (a tail), under one chunk
CHUNKS = {"multiple": (80, 5), "tail": (128, 4), "one_chunk": (512, 1)}
WHITE = (1.0, 1.0, 1.0)


def _engine(kind):
    cfg, argv = SMALL[kind]
    cfgs = update_configs_by_dotlist(load_configs(os.path.join(ROOT, cfg)), argv)
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():  # features large enough that the field varies
        for name, p in model.named_parameters():
            if name.endswith("embeddings"):
                p.mul_(1000.0)
    bound = model.init_bound_state("cpu")
    bound["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(32, 2.0))
    engine = RenderEngine(model, cfgs, bound, "cpu")
    engine.set_render_cap(CAP)
    return engine


def _reference(engine, sample, chunk_rays, bkg=None):
    """The frame as the chunk loop rendered it before its outputs were
    preallocated: each chunk's model call, the per-ray outputs
    concatenated, the valid samples summed. Returns (images, valid)."""
    feed = engine._feed(sample)
    n = feed["rays_o"].shape[0]
    if bkg is not None:
        feed["bkg_color"] = engine._miss_rgb(bkg).expand(n, 3)
    outs, n_valid = [], 0
    with torch.inference_mode():
        for s in range(0, n, chunk_rays):
            chunk = {k: v[None, s:s + chunk_rays] for k, v in feed.items()}
            m = chunk["rays_o"].shape[1]
            out = engine.model(chunk, inference_only=True, bound_state=engine.bound_state)
            n_valid += int(out.pop("n_valid_pts", 0))
            outs.append({k: v[0] for k, v in out.items() if v.ndim >= 2 and v.shape[1] == m})
    return {k: torch.cat([o[k] for o in outs]).reshape((WH, WH) + outs[0][k].shape[1:]) for k in outs[0]}, n_valid


class _LoopGraph(frame_graph.FrameGraph):
    """A frame graph that captures nothing: its frame is the loop on its
    buffers. Stands in for the card's graphs to hold the engine's cache."""

    @staticmethod
    def captures_on(device):
        return True

    def run(self, feed):
        for k, v in feed.items():
            self.inputs[k].copy_(v)
        return self.engine._chunk_loop(self.inputs, self.chunk_rays)


@pytest.fixture
def loop_graphs(monkeypatch):
    """The engine's exact tier through ``_LoopGraph`` on the CPU."""
    monkeypatch.setattr(engine_module, "FrameGraph", _LoopGraph)


def _sample(seed=0):
    """WH x WH rays from a camera at radius 2.5 towards the spheres."""
    g = torch.Generator().manual_seed(seed)
    n = WH * WH
    rays_o = torch.tensor([0.3, -0.2, 2.5]).expand(n, 3).clone()
    rays_d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g) * 0.25 + torch.tensor([0.0, 0.0, -1.0]),
                                           dim=-1)
    return {"rays_o": rays_o, "rays_d": rays_d, "H": WH, "W": WH}


@pytest.fixture(scope="module")
def engines():
    """{kind: engine} on one model each."""
    return {kind: _engine(kind) for kind in SMALL}


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _traced(fn):
    """``fn()`` with tracing on; returns (its result, the record)."""
    profiler.enable()
    try:
        out = fn()
    finally:
        profiler.disable()
    return out, profiler.collect()


@pytest.mark.parametrize("bkg", [None, WHITE], ids=["no_bkg", "bkg"])
@pytest.mark.parametrize("shape", list(CHUNKS))
@pytest.mark.parametrize("kind", list(SMALL))
def test_buffered_chunks_equal_the_eager_loop(engines, kind, shape, bkg):
    # the CPU renders the loop itself (no graph): its chunks write into
    # the frame's preallocated rows, bit for bit the per-chunk loop's frame
    engine = engines[kind]
    chunk, n_chunks = CHUNKS[shape]
    want, n_valid = _reference(engine, _sample(), chunk, bkg)
    got, rec = _traced(lambda: engine.render_image(_sample(), chunk_rays=chunk, bkg_color=bkg))
    assert sorted(want) == (["depth", "mask", "normal", "rgb"] if kind == "neus" else ["depth", "mask", "rgb"])
    assert want["rgb"].shape == (WH, WH, 3) and 0.0 < float(want["mask"].mean()) < 1.0
    _assert_equal(want, got)
    assert int(engine.last_n_valid_pts) == n_valid > 0
    assert [s["name"] for s in rec["spans"]].count("render.chunk") == n_chunks and not engine.graphs
    # a second frame, and its outputs are not the first's
    _assert_equal(_reference(engine, _sample(1), chunk, bkg)[0],
                  engine.render_image(_sample(1), chunk_rays=chunk, bkg_color=bkg))
    _assert_equal(want, got)


def _replace_parameter(engine):
    table = engine.model.fg_model.coarse_geo_net.encoder
    table.embeddings = torch.nn.Parameter(table.embeddings.detach().clone())


def _replace_bitfield(engine):
    engine.bound_state["fg"]["bitfield"] = engine.bound_state["fg"]["bitfield"].clone()


def _replace_bound_state(engine):
    engine.bound_state = {"fg": {k: v.clone() for k, v in engine.bound_state["fg"].items()}}


def _new_cap(engine):
    engine.set_render_cap(CAP)


def _write_in_place(engine):
    with torch.no_grad():
        engine.model.fg_model.coarse_geo_net.encoder.embeddings.mul_(0.5)
        engine.bound_state["fg"]["bitfield"][:16] = False


CHANGES = {"set_render_cap": (_new_cap, True), "replace_parameter": (_replace_parameter, True),
           "replace_bitfield": (_replace_bitfield, True), "replace_bound_state": (_replace_bound_state, True),
           "write_in_place": (_write_in_place, False)}


@pytest.mark.parametrize("change", list(CHANGES))
def test_the_frame_graphs_drop_when_what_they_read_is_replaced(change, loop_graphs):
    # the graphs read the parameters and the occupancy by address, and the
    # render settings as they were at capture: a new tensor or a new cap
    # drops them; a write into the tensors they read keeps them, and the
    # next frame renders the new values
    engine = _engine("ngp")
    engine.render_image(_sample(), chunk_rays=128)
    engine.render_image(_sample(), chunk_rays=80)
    before = dict(engine.graphs)
    assert len(before) == 2
    fn, drops = CHANGES[change]
    fn(engine)
    got = engine.render_image(_sample(), chunk_rays=128)
    kept = [engine.graphs.get(k) is g for k, g in before.items()]
    assert kept == [not drops, not drops] and len(engine.graphs) == 1 + (not drops)
    _assert_equal(_reference(engine, _sample(), 128)[0], got)


@pytest.mark.parametrize("tier", ["windowed", "fast", "interactive"])
def test_the_other_tiers_never_touch_the_frame_graphs(engines, tier, loop_graphs, monkeypatch):
    # the windowed tier's passes take a host read each and march windows;
    # the fast tiers' ray counts move with the frame: all stay eager
    engine = engines["ngp"]

    def refuse(*args, **kwargs):
        raise AssertionError("a frame graph was used")

    monkeypatch.setattr(_LoopGraph, "run", refuse)
    engine.graphs.clear()
    try:
        if tier == "windowed":
            engine.set_render_cap(CAP, window=True)
            out, stats = engine.render_image_windowed(_sample(), n_pass=4, chunk_rays=128, bkg_color=WHITE)
            assert stats["n_pass"] == 4
        elif tier == "fast":
            out, stats = engine.render_image_fast(_sample(), chunk_rays=128, hit_frac=1.0, bkg_color=WHITE)
        else:
            out, stats = engine.render_image_interactive(_sample(), chunk_rays=128, bkg_color=WHITE)
        assert out["rgb"].shape == (WH, WH, 3) and not engine.graphs
    finally:
        engine.set_render_cap(CAP)


@pytest.mark.parametrize("why", ["grid_sampler", "wrapped_encoding", "wrapped_march", "eager", "cpu"])
def test_the_exact_tier_renders_eagerly_where_a_chunk_cannot_replay(why, monkeypatch):
    # no graph where the device captures none (the CPU) or the grid
    # sampler reads its ladder on the host (no bitfield: no fused sampler);
    # a replay calls no Python, so a caller who watches each chunk gets the
    # eager loop, by ``engine.eager()`` or by a wrapped kernel entry, and
    # each such frame counts as ``render.eager``; the same frame either way
    if why != "cpu":
        monkeypatch.setattr(engine_module, "FrameGraph", _LoopGraph)
    engine = _engine("ngp")
    calls = []
    if why == "grid_sampler":
        engine.bound_state = {"fg": {}}
    elif why == "wrapped_encoding":
        inner = encoding.hash_encode
        monkeypatch.setattr(encoding, "hash_encode", lambda xyz, *a, **k: calls.append(xyz) or inner(xyz, *a, **k))
    elif why == "wrapped_march":
        from arcnerf_torch.render import ray_helper

        inner = ray_helper.segment_march_fwd
        monkeypatch.setattr(ray_helper, "segment_march_fwd", lambda *a, **k: calls.append(a) or inner(*a, **k))
    if why == "eager":
        with engine.eager():
            got, rec = _traced(lambda: engine.render_image(_sample(), chunk_rays=128))
    else:
        got, rec = _traced(lambda: engine.render_image(_sample(), chunk_rays=128))
    assert not engine.graphs
    assert rec["counters"].get("render.eager", 0) == (why in ("wrapped_encoding", "wrapped_march", "eager"))
    if why == "wrapped_encoding":
        assert len(calls) == 4  # one encoding call a chunk (the CPU march takes no kernel entry)
    if why == "eager":  # the block ends, the graphs come back
        engine.render_image(_sample(), chunk_rays=128)
        assert len(engine.graphs) == 1
    monkeypatch.undo()
    reference = _engine("ngp")
    if why == "grid_sampler":
        reference.bound_state = {"fg": {}}
    _assert_equal(_reference(reference, _sample(), 128)[0], got)


@pytest.mark.parametrize("kind", list(SMALL))
def test_the_buffered_loop_counts_what_the_eager_loop_counts(engines, kind):
    engine = engines[kind]
    _, want = _traced(lambda: _reference(engine, _sample(), 128, WHITE))
    _, rec = _traced(lambda: engine.render_image(_sample(), chunk_rays=128, bkg_color=WHITE))
    counters = rec["counters"]
    assert counters == want["counters"]
    assert counters["sample.fused"] == 4 and counters["compact.valid"] > 0 and counters["compact.dropped"] == 0
    assert not {"render.replays", "render.captures", "render.eager"} & set(counters)  # no graph on the CPU
    names = [s["name"] for s in rec["spans"]]
    assert names.count("render.chunk") == 4 and "render.replay" not in names
    if kind == "neus":
        # every kept section's normal: the stream's counts, as the sampler writes them
        model, bound = engine.model.fg_model, engine.bound_state["fg"]
        s = _sample()
        kept = 0
        for i in range(0, WH * WH, 128):
            o, d = s["rays_o"][i:i + 128], s["rays_d"][i:i + 128]
            plan = sample_compact.sample_count(model.get_obj_bound().get_obj_bound(), bound["bitfield"], o, d, 64,
                                               model.stream_budget(o.shape[0], True), CAP, sections=True)
            kept += int(plan["cnt"].sum())
        assert counters["sdf.normal_pts"] == kept == counters["compact.valid"]


@pytest.mark.parametrize("kind", list(SMALL))
def test_a_replay_counts_its_chunks_as_the_eager_chunks_count(engines, kind):
    # on the card a replay counts from the chunks' static valid counts, by
    # chunk size: the same counters as the eager chunks', and the chunks
    engine = engines[kind]
    feed = {k: v for k, v in _sample().items() if k in ("rays_o", "rays_d")}
    with torch.inference_mode():
        (_, n_valid), rec = _traced(lambda: engine._chunk_loop(feed, 128))
    want = rec["counters"]
    _, rec = _traced(lambda: frame_graph.FrameGraph(engine, feed, 128)._count(n_valid))
    got = rec["counters"]
    assert got.pop("render.replays") == 4 and got == want and want["sample.fused"] == 4


def test_the_engine_keeps_the_newest_frame_shapes(engines, loop_graphs):
    engine = engines["ngp"]
    engine.graphs.clear()
    for chunk in (64, 80, 96, 112, 128):
        engine.render_image(_sample(), chunk_rays=chunk)
    assert [g.chunk_rays for g in engine.graphs.values()] == [80, 96, 112, 128]
    engine.graphs.clear()


def test_suspended_tracing_records_and_counts_nothing():
    profiler.enable()
    with profiler.span("a"):
        with profiler.suspended():
            assert not profiler.active()
            with profiler.span("b"):
                profiler.count("c", 1)
        assert profiler.active()
        profiler.count("d", 2)
    profiler.disable()
    with profiler.suspended():
        assert not profiler.active()
    assert not profiler.active()
    rec = profiler.collect()
    assert [s["name"] for s in rec["spans"]] == ["a"] and rec["counters"] == {"d": 2}
