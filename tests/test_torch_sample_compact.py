"""The fused sampler (``models/base_modules/sample_compact.py``) on the CPU:

- its plain version equals the path it replaces: ``VolumeBound``'s sampler
  with the jitter drawn from the generator, ``_compact_sel_aux`` and the
  gathers, bit for bit, with jitter, cap, budget overflow and missed rays;
  in the window mode the bound's window (``_cap_pts_per_ray`` with its
  offset) with its counts and, from the dense march's next valid sample,
  each ray's tail;
- a numpy model of the kernel's walk (``csrc/sample_compact.cu``: 32 slots
  a step, the early ends at far, at the cap and at a window's end and
  tail, the jitter's clamp from the kept count, the scan, the write and its
  padding) equals the plain version, the voxel coordinate divided as the
  CPU divides;
- ``NeRF.forward`` gives the same outputs, draws and generator state on
  the fused path as on the grid path, at inference and in training, and a
  window's outputs within f32 sums in another order;
- the dispatch rule: ``sample.fused`` counts the exact tier's chunks and
  the training steps, ``sample.window`` the windowed tier's chunks, and
  neither ``get_progress`` nor a ladder that is not fix-step.
"""

import numpy as np
import pytest
import torch

from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
from arcnerf_torch.models import build_model
from arcnerf_torch.models.base_modules.obj_bound import VolumeBound
from arcnerf_torch.models.base_modules.sample_compact import (gather_stream, sample_compact, sample_count,
                                                              sample_count_reference)
from arcnerf_torch.models.fg_model import FgModel
from arcnerf_torch.render.engine import RenderEngine
from arcnerf_torch.tools.sample_streams import ladder_bitfield, ladder_rand, ladder_rays, ladder_volume
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import dict_to_obj, load_configs, update_configs_by_dotlist
from tests.test_torch_slice import CFG, SMALL, view_rays
from tests.test_torch_step_graph import STRIDED

torch.set_num_threads(1)
STREAM_KEYS = ("z", "pts", "dirs", "off", "cnt", "n_valid", "ray_has")
N_GRID, N_RAYS = 16, 256
# (bitfield, n_pts, jitter, cap, budget, miss share): budgets under the valid
# count (overflow), at it and over every sample; all rays missing; a ragged
# ladder (not a multiple of 32)
CASES = {
    "train_overflow": ("half", 64, True, None, 2048, 0.1),
    "train_scene": ("scene", 64, True, None, 1 << 14, 0.1),
    "serve_capped": ("scene", 64, False, 8, N_RAYS * 8, 0.1),
    "serve_capped_overflow": ("half", 64, False, 8, 1024, 0.1),
    "ragged_ladder_overflow": ("half", 100, True, None, 4096, 0.2),
    "all_miss": ("scene", 64, True, None, 1024, 1.0),
    "empty_bitfield": ("empty", 64, True, None, 1024, 0.1),
    "full_covered": ("full", 64, True, None, N_RAYS * 64, 0.0),
    "full_covered_capped": ("full", 64, False, 16, N_RAYS * 64, 0.0),
}


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    yield
    profiler.disable()


def case_inputs(name, seed=0):
    kind, n_pts, jitter, cap, budget, miss = CASES[name]
    vol = ladder_volume(N_GRID)
    rays_o, rays_d = ladder_rays(vol, N_RAYS, seed, miss)
    rand = ladder_rand(N_RAYS, n_pts, seed + 1) if jitter else None
    return vol, ladder_bitfield(kind, vol, seed), rays_o, rays_d, n_pts, budget, cap, rand


def volume_bound(cap, window=False):
    cfgs = dict_to_obj({"volume": {"n_grid": N_GRID, "side": 2.0}, "epoch_optim": 16, "ray_sample_acc": True,
                        "ray_sample_fix_step": True, "eval_max_pts_per_ray": cap, "eval_cap_window": window})
    return VolumeBound(cfgs)


def assert_streams_equal(got, want):
    for k in STREAM_KEYS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_branch_equals_the_grid_path(name):
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, _ = case_inputs(name)
    jitter = CASES[name][2]
    gen = torch.Generator().manual_seed(7)
    rand = torch.rand((N_RAYS, n_pts), generator=torch.Generator().manual_seed(7)) if jitter else None
    # the path it replaces: the bound's near/far and sampler (the jitter drawn
    # from the generator), the compaction's indices and the gathers
    bound, state = volume_bound(cap), {"bitfield": bitfield}
    near, far, hit = bound.get_near_far_from_rays(state, {"rays_o": rays_o, "rays_d": rays_d})
    zvals, mask = bound.get_zvals_from_near_far(state, near, far, n_pts, inference_only=not jitter, perturb=True,
                                                generator=gen, rays_o=rays_o, rays_d=rays_d, keep_order=True)
    sel, _, off, cnt = FgModel._compact_sel_aux(mask, budget)
    ray_id = sel // n_pts
    z = zvals.reshape(-1)[sel]
    want = {"z": z, "pts": rays_o[ray_id] + z[:, None] * rays_d[ray_id], "dirs": rays_d[ray_id], "off": off,
            "cnt": cnt, "n_valid": mask.sum(), "ray_has": hit & mask.any(dim=1)}
    got = sample_compact(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    assert_streams_equal(got, want)
    assert got["z"].shape == (budget,) and got["pts"].shape == (budget, 3)
    n_valid = int(got["n_valid"])
    overflow = name.endswith("overflow")
    assert (n_valid > budget) == overflow and (n_valid == 0) == (name in ("all_miss", "empty_bitfield"))
    if name.startswith("full_covered"):
        assert int(got["cnt"].sum()) == n_valid > 0  # the budget keeps every sample
    if cap:
        assert int(got["cnt"].max()) <= cap


def slab_model(vol, o, d, eps=np.float32(1e-7)):
    """The kernel's slab test in numpy f32: (near, far, hit) (B,)."""
    f = np.float32
    lo, hi = vol.get_range_np()[:, 0].astype(f), vol.get_range_np()[:, 1].astype(f)
    parallel = np.abs(d) < eps
    miss = (parallel & ((o < lo) | (o > hi))).any(1)
    safe = np.where(parallel, f(1), d)
    t1, t2 = (lo - o) / safe, (hi - o) / safe
    near_raw = np.where(parallel, f(-np.inf), np.minimum(t1, t2)).max(1)
    far_raw = np.where(parallel, f(np.inf), np.maximum(t1, t2)).min(1)
    hit = ~miss & (near_raw <= far_raw) & (far_raw >= 0)
    near = np.where(hit, np.maximum(near_raw, f(0)) + eps, f(0)).astype(f)
    far = np.where(hit, np.maximum(far_raw, f(0)) - eps, f(0)).astype(f)
    return near, far, hit


def kernel_model(vol, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None, offset=None):
    """A numpy model of csrc/sample_compact.cu, launch by launch: a warp a
    ray intersects the box, walks 32 slots a step and ends where the ladder
    reaches far or the cap is met (at ``offset`` + cap in the window mode,
    whose count is the window's); with jitter a first walk counts the
    non-duplicate slots for the clamp; the scan; the write's walk, which
    ends at cnt (a window's skips its first ``offset`` valid samples and
    ends at the tail, rank offset + cnt + 1, which a ray with cnt 0 never
    walks to), and the padding. Every f32 operation rounds as numpy rounds
    it; the voxel coordinate is divided (the CPU's rounding of the plain
    version)."""
    f = np.float32
    o, d = rays_o.numpy(), rays_d.numpy()
    near, far, hit = slab_model(vol, o, d)
    occ = bitfield.numpy().reshape(-1)
    n, fix_t = vol.get_n_grid(), f(vol.get_diag_len() / n_pts)
    start, vs = vol.get_range_np()[:, 0].astype(f), np.asarray(vol.get_voxel_size(), f)
    rand = None if rand is None else rand.numpy()
    b = np.arange(o.shape[0])

    def ladder(j):  # (B, k) slots -> (B, k) z before the jitter
        return np.minimum(np.maximum(near[:, None] + j.astype(f) * fix_t, near[:, None]), far[:, None])

    def duplicate(j):
        return (j > 0) & (ladder(j) == ladder(np.maximum(j - 1, 0)))

    def jittered(j):
        z, prev, nxt = ladder(j), ladder(np.maximum(j - 1, 0)), ladder(np.minimum(j + 1, n_pts - 1))
        lower = np.where(j > 0, f(0.5) * (z + prev), z)
        upper = np.where(j < n_pts - 1, f(0.5) * (nxt + z), z)
        r = rand[b[:, None], np.minimum(j, n_pts - 1)]
        return np.where(duplicate(j), z, lower + (upper - lower) * r)

    def walk(body):  # body(j, alive) per 32-slot step; returns whether the step ends the walk
        alive = np.ones(len(b), bool)
        for base in range(0, n_pts, 32):
            j = np.broadcast_to(base + np.arange(32), (len(b), 32))
            end = body(j, alive)
            alive &= ~(end | (ladder(np.full((len(b), 1), min(base + 31, n_pts - 1)))[:, 0] == far))

    first = last = None
    if rand is not None:
        kept = np.zeros(len(b), np.int64)

        def count_kept(j, alive):
            kept[:] += alive * ((j < n_pts) & ~duplicate(j)).sum(1)
            return np.zeros(len(b), bool)

        walk(count_kept)
        first = jittered(np.zeros((len(b), 1), np.int64))
        last = jittered(np.maximum(kept - 1, 0)[:, None])

    def sample(j):  # -> z, points (B, 32, 3), valid (B, 32)
        z = ladder(j) if rand is None else np.minimum(np.maximum(jittered(j), first), last)
        pts = o[:, None, :] + z[..., None] * d[:, None, :]
        fc = (pts - start) / vs
        inside = ((fc >= 0) & (fc < n)).all(-1)
        idx = np.clip(fc, 0, n - 1).astype(np.int64)
        valid = (j < n_pts) & ~duplicate(j) & inside & occ[(idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]]
        return z, pts, valid

    tot = np.zeros(len(b), np.int64)
    skip = offset or 0  # the valid samples before the window

    def count(j, alive):
        tot[:] += alive * sample(j)[2].sum(1)
        return cap is not None and cap > 0 and tot >= skip + cap

    walk(count)
    if cap:
        tot = np.minimum(np.maximum(tot - skip, 0), cap)
    off = np.cumsum(tot) - tot
    cnt = np.minimum(np.maximum(budget - off, 0), tot)
    z0 = ladder(np.zeros((1, 1), np.int64))[0, 0] if rand is None else min(first[0, 0], last[0, 0])
    out_z = np.full(budget, z0, f)
    out_p = np.broadcast_to(o[0] + z0 * d[0], (budget, 3)).copy()
    out_d = np.broadcast_to(d[0], (budget, 3)).copy()
    rank = np.zeros(len(b), np.int64)
    tail = np.full(len(b), np.inf, f)

    def write(j, alive):
        z, pts, valid = sample(j)
        mine = rank[:, None] + np.cumsum(valid, 1) - valid
        put = alive[:, None] & valid & (mine >= skip) & (mine < skip + cnt[:, None])
        rows = (off[:, None] + mine - skip)[put]
        out_z[rows], out_p[rows], out_d[rows] = z[put], pts[put], np.broadcast_to(d[:, None, :], pts.shape)[put]
        at = (alive & (cnt > 0))[:, None] & valid & (mine == skip + cnt[:, None])
        tail[at.any(1)] = z[at]
        rank[:] += alive * valid.sum(1)
        return rank >= (skip + cnt + 1 if offset is not None else cnt)

    walk(write)
    out = {"z": out_z, "pts": out_p, "dirs": out_d, "off": off, "cnt": cnt, "n_valid": tot.sum(),
           "ray_has": hit & (tot > 0)}
    if offset is not None:
        out.update(n_win=tot.astype(np.int32), tail=tail)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernels_walk_equals_the_plain_version(name):
    args = case_inputs(name, seed=3)
    model = kernel_model(*args)
    plain = sample_compact(*args, count=sample_count_reference)
    for k in STREAM_KEYS:
        np.testing.assert_array_equal(model[k], plain[k].numpy(), err_msg=k)


# --------------------------------------------------------- the window mode
WINDOW_KEYS = STREAM_KEYS + ("n_win", "tail")
# (case, offset in caps): the first window, the second, the eighth, and one
# past every ray's valid samples (the 64-slot ladder)
WINDOWS = [(case, k) for case in ("serve_capped", "serve_capped_overflow", "full_covered_capped")
           for k in (0, 1, 7, "past")]


def window_offset(name, k):
    n_pts, cap = CASES[name][1], CASES[name][3]
    return n_pts if k == "past" else k * cap


def grid_window(name, offset, seed=0):
    """The grid path's window: the bound's sampler in window mode (the
    window's mask and the pre-cap mask), the compaction's indices and the
    gathers, each ray's window count and, from the dense march's view (the
    next valid slot of the pre-cap mask, ``scattered_deltas``' reverse
    cummin), the z its last sample in the stream marches to."""
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, _ = case_inputs(name, seed)
    bound, state = volume_bound(cap, window=True), {"bitfield": bitfield}
    near, far, hit = bound.get_near_far_from_rays(state, {"rays_o": rays_o, "rays_d": rays_d})
    zvals, (mask, pre) = bound.get_zvals_from_near_far(state, near, far, n_pts, inference_only=True, rays_o=rays_o,
                                                       rays_d=rays_d, keep_order=True, cap_offset=offset)
    sel, _, off, cnt = FgModel._compact_sel_aux(mask, budget)
    ray_id = sel // n_pts
    z = zvals.reshape(-1)[sel]
    zm = torch.where(pre, zvals, torch.inf)
    z_next = torch.cat([torch.cummin(zm.flip(1), dim=1).values.flip(1)[:, 1:], torch.full((N_RAYS, 1), torch.inf)], 1)
    last = sel[(off + cnt - 1).clamp(0, budget - 1)] % n_pts  # each ray's last slot in the stream
    tail = torch.where(cnt > 0, z_next.gather(1, last[:, None])[:, 0], torch.inf)
    return {"z": z, "pts": rays_o[ray_id] + z[:, None] * rays_d[ray_id], "dirs": rays_d[ray_id], "off": off,
            "cnt": cnt, "n_valid": mask.sum(), "ray_has": hit & mask.any(dim=1),
            "n_win": mask.sum(1, dtype=torch.int32), "tail": tail}


@pytest.mark.parametrize("name,k", WINDOWS)
def test_window_plain_version_equals_the_grid_paths_window(name, k):
    offset = window_offset(name, k)
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, _ = case_inputs(name)
    got = sample_compact(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, offset=offset)
    want = grid_window(name, offset)
    for key in WINDOW_KEYS:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    n_valid, cnt, n_win, tail = int(got["n_valid"]), got["cnt"], got["n_win"].long(), got["tail"]
    if k == "past":
        assert n_valid == 0 and not bool(got["ray_has"].any()) and bool(torch.isinf(tail).all())
    elif k in (0, 1):
        assert n_valid > 0 and bool(torch.isfinite(tail).any())
    # a ray the budget clips marches to its first dropped window sample; an
    # unclipped ray has a tail only past a full window
    clipped = (cnt > 0) & (cnt < n_win)
    assert bool(torch.isfinite(tail[clipped]).all())
    assert bool((n_win[(cnt > 0) & ~clipped & torch.isfinite(tail)] == cap).all())
    if name == "serve_capped_overflow" and k == 0:
        assert n_valid > budget and bool(clipped.any())


@pytest.mark.parametrize("name,k", WINDOWS)
def test_the_kernels_window_walk_equals_the_plain_version(name, k):
    offset = window_offset(name, k)
    args = case_inputs(name, seed=3)
    model = kernel_model(*args, offset=offset)
    plain = sample_compact(*args, count=sample_count_reference, offset=offset)
    for key in WINDOW_KEYS:
        np.testing.assert_array_equal(model[key], plain[key].numpy(), err_msg=key)


def test_a_window_takes_a_cap_and_samples():
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, _ = case_inputs("serve_capped")
    with pytest.raises(ValueError):
        sample_count(vol, bitfield, rays_o, rays_d, n_pts, budget, None, offset=8)
    with pytest.raises(ValueError):
        sample_count(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, sections=True, offset=8)


# --------------------------------------------------------------- the model
def small_model(extra=()):
    cfgs = update_configs_by_dotlist(load_configs(CFG), list(SMALL) + list(extra))
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0))
    bound_state = model.init_bound_state()
    bound_state["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(16, 2.0))
    return cfgs, model, bound_state


@pytest.mark.parametrize("mode", ["inference_capped", "inference", "training"])
def test_nerf_forward_is_unchanged_on_the_fused_path(mode, monkeypatch):
    cfgs, model, bound_state = small_model(["--model.rays.noise_std", "0.5"])
    fg = model.fg_model
    if mode == "inference_capped":
        RenderEngine(model, cfgs, bound_state, "cpu").set_render_cap(8)
    ro, rd = view_rays(24)
    feed = {"rays_o": torch.from_numpy(ro)[None], "rays_d": torch.from_numpy(rd)[None]}
    training = mode == "training"
    outs, states = [], []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(fg, "fuses_sampling", lambda *args, **kwargs: False)
        gen = torch.Generator().manual_seed(5)
        launches = sample_count.launches
        with torch.inference_mode(not training):
            out = model(feed, inference_only=not training, bound_state=bound_state, generator=gen)
        assert sample_count.launches == launches  # the CPU takes the plain version
        outs.append(out)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])  # the same draws, in the same order
    assert sorted(outs[0]) == sorted(outs[1]) and len(outs[0]) >= 4
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    if training:  # the gradient reaches the nets through the stream
        outs[0]["rgb_coarse"].sum().backward()
        assert any(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in fg.coarse_geo_net.parameters())


@pytest.mark.parametrize("offset", [0, 8, 24, 64])
def test_nerf_forward_window_on_the_stream_equals_the_grid_path(offset, monkeypatch):
    # a window of the transmittance-continuation render: the fused sampler
    # and kernel C's tail mode against the grid, the scattered window mask
    # and the dense march on the pre-cap mask; counts exactly, the images
    # within f32 sums in another order (cumprod against exp of a cumsum)
    cfgs, model, bound_state = small_model()
    fg = model.fg_model
    RenderEngine(model, cfgs, bound_state, "cpu").set_render_cap(8, window=True)
    assert fg.fuses_sampling(bound_state["fg"], cap_offset=offset)
    ro, rd = view_rays(24)
    feed = {"rays_o": torch.from_numpy(ro)[None], "rays_d": torch.from_numpy(rd)[None], "cap_offset": offset}
    outs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(fg, "fuses_sampling", lambda *args, **kwargs: False)
        with torch.inference_mode():
            outs.append(model(feed, inference_only=True, bound_state=bound_state))
    got, want = outs
    assert sorted(got) == sorted(want) == ["depth", "mask", "n_valid_pts", "n_win_pts", "rgb"]
    for k in ("n_valid_pts", "n_win_pts"):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    for k in ("rgb", "depth", "mask"):
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    if offset < 64:
        assert int(got["n_valid_pts"]) > 0
    else:
        assert int(got["n_valid_pts"]) == 0 and not bool(got["rgb"].any())


def test_gather_stream_is_the_grid_paths_gather():
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand = case_inputs("train_scene")
    plan = sample_count(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    z, pts, dirs = gather_stream(plan["sel"], plan["zvals"], rays_o, rays_d)
    ray_id = plan["sel"] // n_pts
    assert torch.equal(dirs, rays_d[ray_id]) and torch.equal(z, plan["zvals"][ray_id, plan["sel"] % n_pts])
    assert torch.equal(pts, rays_o[ray_id] + z[:, None] * rays_d[ray_id])


# ------------------------------------------------------- the dispatch rule
def fused_count():
    return profiler.collect()["counters"].get("sample.fused", 0)


def test_the_exact_tier_counts_each_chunk():
    cfgs, model, bound_state = small_model()
    engine = RenderEngine(model, cfgs, bound_state, "cpu")
    engine.set_render_cap(8)
    ro, rd = view_rays(24)
    profiler.enable()
    engine.render_image({"rays_o": ro, "rays_d": rd, "H": 24, "W": 24}, chunk_rays=64)
    assert fused_count() == 24 * 24 // 64


def test_the_windowed_tier_and_progress_take_the_grid_path():
    # the windowed tier's windows sample through the fused sampler in its
    # window mode: each chunk counts sample.window, none sample.fused, which
    # counts the exact tier's chunks alone; get_progress keeps the grid
    cfgs, model, bound_state = small_model()
    engine = RenderEngine(model, cfgs, bound_state, "cpu")
    engine.set_render_cap(8, window=True)
    ro, rd = view_rays(24)
    profiler.enable()
    imgs, stats = engine.render_image_windowed({"rays_o": ro, "rays_d": rd, "H": 24, "W": 24}, n_pass=4,
                                               chunk_rays=64)
    record = profiler.collect()
    chunks = sum(s["name"] == "render.chunk" for s in record["spans"])
    assert stats["alive_per_pass"][0] > 0 and len(stats["alive_per_pass"]) >= 2 and chunks > 24 * 24 // 64 // 2
    assert record["counters"]["sample.window"] == chunks and fused_count() == 0
    engine.set_render_cap(8)
    engine.render_image({"rays_o": ro, "rays_d": rd, "H": 24, "W": 24}, chunk_rays=64)
    assert fused_count() == 24 * 24 // 64 and profiler.collect()["counters"]["sample.window"] == chunks
    feed = {"rays_o": torch.from_numpy(ro)[None], "rays_d": torch.from_numpy(rd)[None]}
    with torch.inference_mode():
        out = model(feed, inference_only=True, get_progress=True, bound_state=bound_state)
    assert "progress_sigma" in out and fused_count() == 24 * 24 // 64


def test_a_ladder_that_is_not_fix_step_takes_the_grid_path():
    cfgs, model, bound_state = small_model(["--model.obj_bound.ray_sample_fix_step", "False"])
    assert not model.fg_model.fuses_sampling(bound_state["fg"])
    engine = RenderEngine(model, cfgs, bound_state, "cpu")
    engine.set_render_cap(8)
    ro, rd = view_rays(16)
    profiler.enable()
    engine.render_image({"rays_o": ro, "rays_d": rd, "H": 16, "W": 16}, chunk_rays=64)
    assert fused_count() == 0 and profiler.collect()["counters"]["compact.valid"] > 0
    # its windows keep the grid too
    engine.set_render_cap(8, window=True)
    assert not model.fg_model.fuses_sampling(bound_state["fg"], cap_offset=8)
    engine.render_image_windowed({"rays_o": ro, "rays_d": rd, "H": 16, "W": 16}, n_pass=4, chunk_rays=64)
    assert "sample.window" not in profiler.collect()["counters"] and fused_count() == 0


def test_the_bound_alone_opens_a_window(monkeypatch):
    # cap_offset is a window only where the bound opens one (obj_bound.window:
    # eval_cap_window, at inference); elsewhere the call samples as a plain
    # one, on the stream, with the grid path's outputs. A window without a
    # cap keeps the grid: S's window mode takes a cap
    cfgs, model, bound_state = small_model()
    fg, bound, state = model.fg_model, model.fg_model.obj_bound, bound_state["fg"]
    engine = RenderEngine(model, cfgs, bound_state, "cpu")
    engine.set_render_cap(8)
    assert bound.window(8, True) is None and fg.fuses_sampling(state, cap_offset=8)
    ro, rd = view_rays(16)
    feed = {"rays_o": torch.from_numpy(ro)[None], "rays_d": torch.from_numpy(rd)[None], "cap_offset": 8}
    with torch.inference_mode():
        got = model(feed, inference_only=True, bound_state=bound_state)
        monkeypatch.setattr(fg, "fuses_sampling", lambda *args, **kwargs: False)
        want = model(feed, inference_only=True, bound_state=bound_state)
    monkeypatch.undo()
    assert sorted(got) == sorted(want) and "n_win_pts" not in got
    for k in got:
        assert torch.equal(got[k], want[k]), k
    engine.set_render_cap(8, window=True)
    assert bound.window(8, True) == 8 and bound.window(None, True) is None and fg.fuses_sampling(state, cap_offset=8)
    assert bound.window(8, False) is None and fg.fuses_sampling(state, cap_offset=8, inference_only=False)
    engine.set_render_cap(None, window=True)
    assert bound.window(8, True) == 8 and not fg.fuses_sampling(state, cap_offset=8) and fg.fuses_sampling(state)


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_training_steps_count_the_fused_sampler(scan_steps, tmp_path):
    from arcnerf_torch.trainer import ArcNerfTrainer

    cfgs = update_configs_by_dotlist(load_configs(CFG), STRIDED + [
        "--dir.expr_dir", str(tmp_path / "t"), "--progress.scan_steps", str(scan_steps)])
    trainer = ArcNerfTrainer(cfgs)
    profiler.enable()
    for epoch in range(0, 8, scan_steps):
        trainer.train_steps(epoch, scan_steps)
    assert fused_count() == 8
