"""The render engine's prepasses on the port alone (CPU, the small model of
``test_torch_slice.py``): a windowed frame walks the occupancy ladder once
on each of its budget ladders, and the exact hit prepass is the set of rays
the count prepass gives a sample, which is what lets the windowed tier hand
its counts on as the hit set."""

import pytest
import torch

from arcnerf_torch.render.engine import RenderEngine
from arcnerf_torch.utils import profiler
from tests.test_torch_tracing import CAP, CHUNK, WHITE, engine, sample

# the windowed tier's budget ladders (calibrated: no budget_rays, so the
# pass-0 budget comes from the hit count)
LADDERS = {"counted": {}, "calibrated": {"pass_budget_rays": (256, 128, 64)},
           "geometric": {"adaptive_budget": False, "alive_frac": 0.5, "hit_frac": 0.6}}


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    yield
    profiler.disable()


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_a_windowed_frame_walks_the_ladder_once(ladder, monkeypatch):
    e = engine()
    e.set_render_cap(CAP, window=True)
    calls = []
    for name in ("_hit_prepass", "_count_prepass"):
        inner = getattr(RenderEngine, name)

        def spy(self, *args, _inner=inner, _name=name, **kwargs):
            calls.append(_name)
            return _inner(self, *args, **kwargs)

        monkeypatch.setattr(RenderEngine, name, spy)
    profiler.enable()
    _, stats = e.render_image_windowed(sample(), n_pass=4, chunk_rays=CHUNK, bkg_color=WHITE, **LADDERS[ladder])
    profiler.disable()
    rec = profiler.collect()
    assert 0.0 < stats["hit_frac"] < 1.0 and stats["alive_per_pass"][0] > 0
    assert len(calls) == 1, calls
    assert [s["attrs"]["kind"] for s in rec["spans"] if s["name"] == "render.prepass"] == \
        ["hit" if calls == ["_hit_prepass"] else "count"]
    assert rec["reads"]["render.hit_count"] == 1


@pytest.mark.parametrize("seed,n_sample", [(0, None), (1, 32)])  # the training ladder; a coarser serving one
def test_the_exact_hit_prepass_is_the_rays_the_count_prepass_gives_a_sample(seed, n_sample):
    e = engine()
    e.set_render_cap(CAP, n_sample=n_sample)
    bitfield = e.bound_state["fg"]["bitfield"]
    e.bound_state["fg"]["bitfield"] = torch.rand(bitfield.shape, generator=torch.Generator().manual_seed(seed)) < 0.05
    rays = sample()
    ro, rd = torch.from_numpy(rays["rays_o"]), torch.from_numpy(rays["rays_d"])
    hit = e._hit_prepass(e.bound_state, ro, rd, n_probe=0)
    counts = e._count_prepass(e.bound_state, ro, rd)
    assert hit.dtype == torch.bool and counts.dtype == torch.int32
    assert 0 < int(hit.sum()) < hit.numel()
    assert torch.equal(hit, counts > 0)
